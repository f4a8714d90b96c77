"""The benchmark of the PyTorch/H100 port (``mmdgan_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's card: set-up, a
measured window of ``--seconds``, then the check against the plain
reference. The last line of standard output is the result, one JSON
object; the last lines of standard error are the numbers compared, each
beside its limit. Without a CUDA card, or with fewer cards than the cell
asks for, it exits with 2 and prints no result; it exits with 3, and no
result, when the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    harness.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in harness.format_compared(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
