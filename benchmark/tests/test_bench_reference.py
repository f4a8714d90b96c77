"""The plain reference against the port at a small size on the CPU, in
float32: one train step of ``build_train_step`` and the exported
generator of ``export_generator`` / ``load_exported``, from the same
weights, rows and codes. And the reference stands alone: it imports
nothing of the port, JAX or the JAX package."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import _port
from benchmark.reference import check, mmdgan
from benchmark.tests.helpers import FIXTURES

CFG = harness.load_json(os.path.join(FIXTURES, "configs", "tiny.json"))
SPECS = mmdgan.leaf_specs(CFG["architecture"])
CPU = torch.device("cpu")


def test_reference_imports_nothing_of_the_program_or_jax():
    folder = os.path.join(harness.BENCH_DIR, "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] in ("torch", "numpy", "benchmark", "__future__",
                                           "contextlib", "math", "typing"), (name, m)
    code = ("import sys; import benchmark.reference.check, benchmark.reference.mmdgan; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'mmdgan_torch', 'mmdgan_tpu', "
            "'jax', 'jaxlib', 'flax', 'optax', 'experiments', 'tools'}; "
            "sys.exit(len(bad))")
    assert subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT).returncode == 0


def test_one_train_step_matches_the_port():
    from mmdgan_torch.train.step import build_train_step, init_train_state

    model, opt_d, opt_g = _port.build(CFG, CPU)
    ts = init_train_state(model, 1, opt_d, opt_g, device=CPU)
    state0 = _port.make_state(CFG, SPECS, 7, CPU)
    _port.write_state(ts, state0)
    ts.rng.manual_seed(11)
    x = torch.randint(0, 256, (8, 8, 8, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    z = torch.randn(8, 8, generator=torch.Generator().manual_seed(11))
    ts, metrics = build_train_step(model, opt_d, opt_g, device=CPU)(ts, {"x": x})

    ref = {n: t.clone() for n, t in state0.items()}
    mmdgan.init_optimizer_state(ref, SPECS)
    out = mmdgan.train_step(CFG, SPECS, ref, x, z)
    for k in ("loss_gen", "loss_dis", "e_kxx", "e_kxy", "e_kyy", "grad_norm_dis",
              "grad_norm_gen", "x_gen_abs_mean"):
        assert float(metrics[k]) == pytest.approx(out[k], rel=1e-4, abs=1e-6), k
    prog = _port.read_state(ts, SPECS)
    # the score layer's bias has no gradient but round-off (MMD is
    # shift-invariant): Adam moves it by its sign, in both
    mu = {n: float(ref[f"mu/{n}"].norm()) for n, v in SPECS.items() if v["group"] == "param"}
    floor = check.NEGLIGIBLE_GRADIENT * np.median(list(mu.values()))
    noise = {n for n, g in mu.items() if g < floor}
    assert noise == {"dis/l4_s/bias/bias"}
    for n in ref:
        if n.startswith("count/") or n.split("/", 1)[-1] in noise or n in noise:
            continue
        np.testing.assert_allclose(prog[n].numpy(), ref[n].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_exported_generator_matches_the_reference(tmp_path):
    from types import SimpleNamespace

    from mmdgan_torch.utils.export import export_generator, load_exported

    model, _, _ = _port.build(CFG, CPU)
    params, state, _ = model.init(0)
    held = SimpleNamespace(params=params, net_state=state)
    gen = {n: v for n, v in SPECS.items() if n.startswith("gen/")}
    state0 = _port.make_state(CFG, gen, 5, CPU)
    _port.write_state(held, state0)
    path = export_generator(model, params, state, 16, str(tmp_path / "g.pt2"), device=CPU)
    z = torch.randn(16, 8, generator=torch.Generator().manual_seed(2))
    served = load_exported(path, device=CPU)(z).numpy()
    ref = mmdgan.generate(CFG["architecture"], state0, z).numpy()
    assert check.serve_gap([served], [ref]) < 1e-5


def test_the_control_is_computed_in_float8():
    state = _port.make_state(CFG, {n: v for n, v in SPECS.items() if n.startswith("gen/")},
                             5, CPU)
    z = torch.randn(16, 8, generator=torch.Generator().manual_seed(2))
    exact = mmdgan.generate(CFG["architecture"], state, z).numpy()
    fp8 = mmdgan.generate(CFG["architecture"], state, z, precision="fp8").numpy()
    assert check.serve_gap([fp8], [exact]) > 1e-2
