"""The five studies of the port (``mmdgan_torch/tools/{kernel_study,
conv_study,tc_study,hbm_study,export_study}.py``) against the JAX tools
they port (``tools/{pallas_study,conv_study,tc_study,hbm_study,
export_study}.py``), on the CPU at small sizes.

- Every variant of the conv and tc studies is exact against the port's
  direct route at two small shapes in NCHW and in ``channels_last``, and
  against the JAX tool's own function of the same name on the same
  seeded numpy inputs (float32; the studies' gates: 1e-5 relative for the
  convs, 2e-5 for the transposed convs).
- The kernel study's scalar and its gradient, on the plain path, against
  JAX's ``_means_reference`` (rtol 1e-5 / atol 1e-6; the gradient rtol
  1e-4 / atol 1e-7).
- hbm's six variants run a K=2, b4 window of a narrow model with finite
  losses; the rows that ``pregather``, ``pregather32`` and ``cursor`` feed
  the steps are the rows their index draws and cursor name.
- export's three surfaces give the same images (atol 1e-6) at b8.
- Each tool prints its JAX tool's keys: the same tables (JAX's ``pallas``
  columns are the port's ``kernel``), shapes and variants, and JSON keys
  (export less ``exp_multi``, whose ``exp_tpu`` is the port's ``exp``).
  The JAX tools run here with their timers stubbed, at a tiny shape.
"""

import json
import re
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.ops.pallas_mmd import _means_reference
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.tools import conv_study, export_study, hbm_study, kernel_study, tc_study
from mmdgan_torch.train import step as step_module
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.step import build_train_step, init_train_state
from mmdgan_torch.utils.jax_bridge import _conv_t as bridge_tc_kernel
from tools import conv_study as jax_conv
from tools import export_study as jax_export
from tools import hbm_study as jax_hbm
from tools import pallas_study as jax_pallas
from tools import tc_study as jax_tc

torch.set_num_threads(1)
LAYOUTS = ("nchw", "channels_last")
NARROW = {
    "input": [(3, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 16 * 2 * 2, "op": "d", "act": "linear", "act_nm": None,
         "out_reshape": [16, 2, 2]},
        {"name": "l2_up", "out": 8, "op": "tc", "act": "relu", "act_nm": "bn", "kernel": 4,
         "strides": 2},
        {"name": "l3_t8", "out": 3, "op": "tc", "act": "tanh", "act_nm": None, "kernel": 4,
         "strides": 2},
    ],
    "discriminator": [
        {"name": "l1_f8", "out": 8, "act": "lrelu", "w_nm": "s"},
        {"name": "l2_ds", "out": 16, "act": "lrelu", "w_nm": "s", "kernel": 4, "strides": 2,
         "out_reshape": [16 * 4 * 4]},
        {"name": "l3_s", "out": 4, "op": "d", "w_nm": "s"},
    ],
}
# the smallest model JAX's export study can build: the keys, not the rates
TINY = {"input": [(3, 4, 4)], "code": [(4, "linear")],
        "generator": [{"name": "l1", "out": 48, "op": "d", "act": "tanh", "act_nm": None,
                       "out_reshape": [3, 4, 4]}],
        "discriminator": [{"name": "l1_s", "out": 2, "op": "d", "in_reshape": [48]}]}


def _nchw(a: np.ndarray, layout: str) -> torch.Tensor:
    return conv_study.to_layout(torch.tensor(a).permute(0, 3, 1, 2), layout)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(8, 3, 5, 3, 1), (8, 4, 6, 4, 2), (6, 3, 4, 4, 2)])
def test_conv_variants_exact_against_direct_and_jax(shape, layout):
    h, cin, cout, k, s = shape
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, h, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.05).astype(np.float32)
    xt, wt = _nchw(x, layout), conv_study.to_layout(torch.tensor(w).permute(3, 2, 0, 1), layout)
    fns = conv_study.variants(cin, k, s)
    assert set(fns) == {"direct", "im2col"} | ({"s2d"} if k == 4 else set()) | (
        {"pad8"} if cin == 3 else set())
    want_direct = np.asarray(jax_conv.direct(jnp.asarray(x), jnp.asarray(w), s))
    ref = fns["direct"](xt, wt, s)
    assert _rel(_nhwc(ref), want_direct) < conv_study.GATE
    for name, fn in fns.items():
        got = fn(xt, wt, s)
        assert _rel(_nhwc(got), _nhwc(ref)) < conv_study.GATE, name
        want = np.asarray(getattr(jax_conv, name)(jnp.asarray(x), jnp.asarray(w), s))
        assert _rel(_nhwc(got), want) < conv_study.GATE, name
    conv_study.gate(fns, (xt.float(), wt.float(), s), conv_study.GATE, "small")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("h,cin,cout", [(4, 6, 5), (8, 3, 3)])
def test_tc_variants_exact_against_direct_and_jax(h, cin, cout, layout):
    rng = np.random.RandomState(1)
    x = rng.randn(2, h, h, cin).astype(np.float32)
    w = (rng.randn(4, 4, cin, cout) * 0.05).astype(np.float32)
    xt = _nchw(x, layout)
    wt = conv_study.to_layout(torch.tensor(np.ascontiguousarray(bridge_tc_kernel(w))), layout)
    want = {"direct": jax_tc.direct(jnp.asarray(x), jnp.asarray(w)),
            "ps2": jax_tc.ps2(jnp.asarray(x), jnp.asarray(w)),
            "ps3": jax_tc.ps3(jnp.asarray(x), jax_tc._ps3_kernel(jnp.asarray(w))),
            "grad": jax_tc.grad_form(jnp.asarray(x), jnp.asarray(w))}
    ref = tc_study.direct(xt, wt)
    for name, fn in tc_study.GATED.items():
        got = _nhwc(fn(xt, wt))
        assert _rel(got, _nhwc(ref)) < tc_study.GATE, name
        assert _rel(got, np.asarray(want[name])) < tc_study.GATE, name
    # the timed ps3 form: ps3_conv on the kernel made once
    got = tc_study.ps3_conv(xt, tc_study.ps3_kernel(wt))
    assert _rel(_nhwc(got), np.asarray(want["ps3"])) < tc_study.GATE
    # and differentiable, as the study's forward+backward times it
    fwd_bwd = conv_study.fwd_bwd(tc_study.grad_form, xt, wt)
    torch.testing.assert_close(fwd_bwd(), conv_study.fwd_bwd(tc_study.direct, xt, wt)(),
                               rtol=1e-5, atol=1e-5)
    tc_study.gate(tc_study.GATED, (xt, wt), tc_study.GATE, "small")


def test_a_variant_that_misses_its_gate_raises():
    x, w = torch.randn(2, 4, 8, 8), torch.randn(6, 4, 4, 4)
    wrong = {"direct": conv_study.direct, "s2d": lambda x, w, s: conv_study.direct(x, w, s) * 1.01}
    with pytest.raises(RuntimeError, match="s2d"):
        conv_study.gate(wrong, (x, w, 2), conv_study.GATE, "l2_ds")


@pytest.mark.parametrize("b,d", [(64, 16), (8, 256)])
def test_kernel_study_scalar_and_grad_match_jax(b, d):
    sg, sx = kernel_study.scores(b, d, "cpu")

    def jax_scalar(a, c):
        e = _means_reference(a, c, 1.0)
        return e[0] - 2.0 * e[1] + e[2] + 0.1 * (e[3] - e[4] + e[5])

    v_want, g_want = jax.value_and_grad(jax_scalar)(jnp.asarray(sg.numpy()), jnp.asarray(sx.numpy()))
    for fused in (False, True):   # on the CPU the fused wrapper takes the plain version
        v, g = kernel_study.value_and_grad(fused, sg, sx)
        np.testing.assert_allclose(float(v), float(v_want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_want), rtol=1e-4, atol=1e-7)
    assert kernel_study.gate(b, d, "cpu") >= 0.0
    assert kernel_study.micro_bench(b, d, 2, True, True, "cpu", repeats=1) > 0


# the bounds PERF.md records for the kernel pair (ms; forward, backward):
# the yardstick reads the same work whatever implements the kernels
BOUNDS_MS = {(16, 16): (6.19e-7, 1.23e-6, "bytes"), (64, 16): (4.67e-6, 1.24e-5, "operations"),
             (256, 16): (7.44e-5, 1.99e-4, "operations"),
             (64, 256): (6.38e-5, 1.88e-4, "operations"),
             (256, 256): (1.02e-3, 3.01e-3, "operations")}


@pytest.mark.parametrize("b,d", sorted(BOUNDS_MS))
def test_kernel_bounds_hold_their_recorded_values(b, d):
    """One bound function per kernel (``kernel_study``'s, which
    ``chip_smoke.py`` imports): their values at the recorded shapes, to the
    three digits recorded."""
    fwd, bwd, by = BOUNDS_MS[(b, d)]
    got_fwd, fwd_by, _ = kernel_study.kernel_means_bound_ms(b, d)
    got_bwd, bwd_by, _ = kernel_study.kernel_means_backward_bound_ms(b, d)
    assert got_fwd == pytest.approx(fwd, rel=5e-3) and fwd_by == by
    assert got_bwd == pytest.approx(bwd, rel=5e-3) and bwd_by == by
    import chip_smoke

    assert chip_smoke.kernel_means_bound_ms is kernel_study.kernel_means_bound_ms
    assert chip_smoke.kernel_means_backward_bound_ms is kernel_study.kernel_means_backward_bound_ms


def _opts():
    return multi_opt_config([5e-4, 2e-4])


def test_hbm_variants_run_and_feed_the_expected_rows(monkeypatch):
    """K=2, b4 over 64 seeded rows: every variant's window ends finite; the
    rows the steps see are those expected: ``pregather``'s one draw of K*B
    indices from the window's generator (decoded at gather time for
    ``pregather32``), ``cursor``'s contiguous rows at step * B, ``base``'s
    B indices per step."""
    seen = []
    real = step_module.build_train_step

    def recording_build(*args, **kwargs):
        step = real(*args, **kwargs)

        def recording(ts, batch, *rest, **kw):
            seen.append(batch["x"].clone())
            return step(ts, batch, *rest, **kw)

        recording.dp = step.dp
        return recording

    monkeypatch.setattr(step_module, "build_train_step", recording_build)
    k, b, rows = 2, 4, 64
    for name in hbm_study.VARIANTS:
        seen.clear()
        call, ts = hbm_study.make_variant(name, device="cpu", scan_k=k, batch=b, rows=rows,
                                          architecture=NARROW)
        rng_before = call.rng.get_state()
        ts, m = call(ts)
        assert torch.isfinite(m["loss_gen"]).all() and torch.isfinite(m["loss_dis"]).all(), name
        assert m["loss_gen"].shape == (k,)
        data = call.data
        if name == "synthetic":
            assert data is None
            continue
        assert len(seen) == k, name
        replay = torch.Generator().set_state(rng_before)
        if name in ("pregather", "pregather32"):
            idx = torch.randint(0, rows, (k * b,), generator=replay)
            want = data.index_select(0, idx)
            if name == "pregather32":
                want = want.float() / 127.5 - 1.0
        elif name == "cursor":
            want = data[: k * b]
        else:   # base and f32data: B uniform indices per step
            want = torch.cat([data.index_select(0, torch.randint(0, rows, (b,), generator=replay))
                              for _ in range(k)])
        assert torch.equal(torch.cat(seen), want), name
    assert data.dtype == torch.uint8 and call.data.shape == (rows, 8, 8, 3)


def test_hbm_pregather_window_keeps_its_generator_across_windows():
    model = SNGan(NARROW, device="cpu", compute_dtype=torch.float32)
    opt_d, opt_g = _opts()
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    fn = hbm_study.pregather_window(build_train_step(model, opt_d, opt_g, device="cpu"), 2, 4,
                                    decode32=True)
    data = hbm_study.dataset(16, 8, "uint8", "cpu")
    rng = torch.Generator().manual_seed(1)
    for _ in range(2):
        ts, m = fn(ts, data, rng)
    assert torch.isfinite(m["loss_dis"]).all() and int(ts.step) == 4
    assert not torch.equal(rng.get_state(), torch.Generator().manual_seed(1).get_state())


def test_export_surfaces_give_the_same_images(tmp_path):
    model = SNGan(NARROW, device="cpu", compute_dtype=torch.float32)
    params, state, _ = model.init(0)
    fns = export_study.surfaces(model, params, state, 8, torch.device("cpu"), str(tmp_path))
    assert set(fns) == {"model", "exp", "exp_args"}
    z = torch.tensor(np.random.RandomState(0).randn(8, model.code_size).astype(np.float32))
    want = fns["model"](z)
    assert want.shape == (8, 8, 8, 3)
    for name in ("exp", "exp_args"):
        torch.testing.assert_close(fns[name](z), want, rtol=0, atol=1e-6, msg=name)


def _table(text: str) -> list:
    return [line for line in text.splitlines() if line.startswith("|")]


def test_kernel_study_prints_jax_tables(monkeypatch, capsys):
    monkeypatch.setattr(jax_pallas, "micro_bench", lambda *a, **k: 1e-6)
    monkeypatch.setattr(jax_pallas, "step_bench", lambda *a, **k: 100.0)
    monkeypatch.setattr(sys, "argv", ["pallas_study.py"])
    jax_pallas.main()
    want = _table(capsys.readouterr().out)
    monkeypatch.setattr(kernel_study, "micro_bench", lambda *a, **k: 1e-6)
    monkeypatch.setattr(kernel_study, "step_bench", lambda *a, **k: 100.0)
    monkeypatch.setattr(kernel_study, "gate", lambda *a: 0.0)
    assert kernel_study.main(["--device", "cpu"]) == 0
    got = _table(capsys.readouterr().out)
    cells = lambda line: [c.strip() for c in line.strip("|").split("|")]   # noqa: E731
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = [c.replace("pallas", "kernel") for c in cells(w)]
        g = cells(g)
        if w[0] == "B" or w[0].startswith("-"):   # the microbench's header: bounds appended
            assert g[:len(w)] == w and (w[0] != "B" or g[len(w):] == ["fwd bound",
                                                                        "fwd+grad bound"])
        elif len(w) == 6:   # a microbench row: B and d
            assert g[:2] == w[:2]
        elif w[0] == "loss":
            assert g == w
        else:               # a step row: loss and batch
            assert g[:2] == w[:2]


def test_conv_study_prints_jax_table(monkeypatch, capsys):
    shapes = [("l1_f64 3x3/s1 3->64", 8, 8, 3, 4, 3, 1), ("l2_ds 4x4/s2 64->128", 8, 8, 4, 6, 4, 2)]
    monkeypatch.setattr(jax_conv, "SHAPES", shapes)
    monkeypatch.setattr(jax_conv, "B", 2)
    monkeypatch.setattr(jax_conv, "timed", lambda *a: 1e-6)
    jax_conv.main()
    want = _table(capsys.readouterr().out)
    monkeypatch.setattr(conv_study, "SHAPES", shapes)
    assert conv_study.main(["--device", "cpu", "--batch", "2", "--inner", "1",
                            "--repeat", "1"]) == 0
    out = capsys.readouterr().out
    got = _table(out)
    rows = lambda table: sorted(tuple(c.strip() for c in line.split("|")[1:3])   # noqa: E731
                                for line in table[2:])
    assert got[:2] == want[:2] and got[len(got) // 2:][:2] == want[:2]
    assert rows(got[:len(got) // 2]) == rows(want) == rows(got[len(got) // 2:])
    assert "## nchw" in out and "## channels_last" in out


def test_tc_study_prints_jax_rows(monkeypatch, capsys):
    shapes = [("g4 16x16 128->64 (cifar)", 4, 6, 5), ("g6 64x64 64->3 (hd128)", 8, 4, 3)]
    monkeypatch.setattr(jax_tc, "SHAPES", shapes)
    monkeypatch.setattr(jax_tc, "B", 2)
    monkeypatch.setattr(jax_tc, "_bench", lambda *a: 1.0)
    monkeypatch.setattr(jax_tc, "_bench_bwd", lambda *a: 1.0)
    jax_tc.main()
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(tc_study, "SHAPES", shapes)
    assert tc_study.main(["--device", "cpu", "--batch", "2", "--inner", "1", "--repeat", "1"]) == 0
    got = capsys.readouterr().out.splitlines()
    key = lambda line: tuple(c.strip() for c in line.split("|")[1:3])   # noqa: E731
    want_rows = [key(line) for line in want if line.startswith("|")]
    for layout in LAYOUTS:
        assert [key(line.split("] ", 1)[1]) for line in got
                if line.startswith(f"[{layout}] |")] == want_rows
    summary = lambda lines: Counter(re.findall(r"(\w+) +fwd x", "\n".join(lines)))  # noqa: E731
    assert summary(got) == Counter({v: 2 * n for v, n in summary(want).items()})
    assert set(summary(want)) == {"ps2", "ps3", "grad"}
    assert sum("exactness ok" in line for line in got) == len(shapes)


def test_hbm_study_prints_jax_json(monkeypatch, capsys):
    monkeypatch.setattr(jax_hbm, "run_variant", lambda *a: 1.0)
    monkeypatch.setattr(sys, "argv", ["hbm_study.py"])
    jax_hbm.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(hbm_study, "run_variant", lambda *a: 1.0)
    assert hbm_study.main(["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == {"arch", "steps", "steps_per_sec"}
    assert list(got["steps_per_sec"]) == list(want["steps_per_sec"]) == list(hbm_study.VARIANTS)
    assert (got["arch"], got["steps"]) == (want["arch"], want["steps"])


def test_export_study_prints_jax_json(monkeypatch):
    import experiments.architectures as jax_arch
    from mmdgan_torch import architectures
    from mmdgan_torch.tools import serving_bench

    monkeypatch.setattr(jax_arch, "cifar_architecture", lambda: TINY)
    monkeypatch.setattr(jax_export, "_measure", lambda *a: 1.0)
    want = jax_export.study("cifar", 2)
    monkeypatch.setattr(architectures, "cifar_architecture", lambda: TINY)
    monkeypatch.setattr(serving_bench, "images_per_sec", lambda *a: 1.0)
    got = export_study.study("cifar", 2, "cpu")
    assert set(got) == set(want)
    names = {"exp": "exp_tpu"}
    for key in ("img_per_sec", "vs_model"):
        assert {names.get(k, k) for k in got[key]} == set(want[key]) - {"exp_multi"}
    assert (got["arch"], got["batch"], got["platform"]) == ("cifar", 2, "cpu") == (
        want["arch"], want["batch"], want["platform"])


@pytest.mark.parametrize("tool", [kernel_study, conv_study, tc_study, hbm_study, export_study],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_studies_run_on_the_card_unless_asked_for_the_cpu(monkeypatch, tool):
    """Each study defaults to ``cuda`` and, with no GPU, raises naming
    ``device='cpu'`` before it measures anything: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
