"""What the benchmark's tests share: the fixture's cells, run on the CPU."""

import os

from benchmark import harness

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SEED = 2 ** 31 + 12345   # larger than 32 signed bits hold, as the driver's seeds are


def fixture_spec() -> dict:
    return harness.load_json(os.path.join(FIXTURES, "BENCHMARK.json"))


def run_fixture(cell: str, seconds: float = 0.5, trace: bool = False, seed: int = SEED) -> dict:
    """A whole run of a fixture cell on the CPU: the harness without its
    look for a card."""
    return harness.run_cell(fixture_spec(), cell, seed, seconds, trace, device="cpu",
                            bench_dir=FIXTURES)
