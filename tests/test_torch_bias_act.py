"""The fused bias, cast and activation of a conv block
(``mmdgan_torch/ops/cuda_bias_act.py``, ``csrc/bias_act.cu``).

On the card a ``default`` block with a plain bias, no BN and a linear, relu,
lrelu or tanh activation runs its epilogue as one kernel each way where
``models/ops.py`` ``bias_act_route`` holds. On the CPU the route is taken
through ``nhwc_route``'s internal argument (``_any_device``), as
``tests/test_torch_layout.py`` takes the NHWC route, and the two launchers
are replaced by the plain ops they reproduce (``models/ops.py``
``bias_act_plain``, ``bias_act_plain_backward``), so the CPU runs the
routing and the autograd functions around the kernels (``BiasAct``,
``BiasActGrad`` and its closed-form backward), not the kernels. Each case
runs one block, the whole generator and discriminator of a benchmark
configuration, a double backward, or a train step, twice on the NHWC route
from the same parameters and input: fused, and with the fused route
switched off (``layers.bias_act_route``). Outputs and activation gradients
agree bitwise; the bias's gradient, summed as the plain route sums it,
within float32 rounding. The launches a train step makes are
``chip_smoke.py``'s ``bias_act_per_step``, which the card's counters are
held to.

The geometry test runs the kernels' index arithmetic in Python over small
maps and grids: every (row, channel) of the map is visited once.

The ``card`` tests need a CUDA card and skip here; on the card, without
the JAX test configuration: ``python -m pytest --noconftest
tests/test_torch_bias_act.py -m card``.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmdgan_torch.architectures import celeba_architecture, cifar_architecture, hd_architecture
from mmdgan_torch.models import layers, ops
from mmdgan_torch.models.layers import Layer
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops import cuda_bias_act
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import tree_leaves, tree_map
from mmdgan_torch.train.step import (build_grad_accum_step, build_imbalanced_multi_step,
                                      build_train_step, init_train_state)
from mmdgan_torch.utils import spans

torch.set_num_threads(1)
ACTS = cuda_bias_act.ACTS
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}
F32_SUM_TOL = 1e-5   # a float32 sum in another order, relative to the sum of magnitudes


def route_on(monkeypatch):
    """The NHWC route on the CPU, and the launchers replaced by the plain
    ops; returns the launches made, [forward, backward]."""
    monkeypatch.setattr(ops, "nhwc_route", functools.partial(ops.nhwc_route, _any_device=True))
    return plain_launchers(monkeypatch)


def plain_launchers(monkeypatch):
    """The two launchers replaced by the plain ops they reproduce, for CPU
    tensors; returns the launches made, [forward, backward]."""
    made = [0, 0]

    def forward(x, bias, act):
        made[0] += 1
        return ops.bias_act_plain(x, bias, act)

    def backward(g, y, act, bias_grad):
        made[1] += 1
        gx, gb = ops.bias_act_plain_backward(g, y, act, bias_grad)
        return (gx.clone() if gx is g else gx), gb   # a new map, as the kernel writes
    monkeypatch.setattr(cuda_bias_act, "bias_act_forward_cuda", forward)
    monkeypatch.setattr(cuda_bias_act, "bias_act_backward_cuda", backward)
    return made


def fused_off(monkeypatch):
    monkeypatch.setattr(layers, "bias_act_route", lambda x, compute_dtype: False)


def counted(fn):
    """``fn()`` under the profiler (so spans count), and the counters."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = spans.counters()
    spans.clear()
    return out, got


def assert_equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    gap = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), f"{what}: differs by up to {gap}"


def assert_sum_close(got, want, terms, what):
    """Two float32 sums over the rows of the map ``terms`` (or of a map at
    least as large) in other orders: within float32 rounding of the sum of
    magnitudes."""
    scale = terms.float().abs().sum((0, 2, 3))
    gap = (got - want).abs()
    assert (gap <= F32_SUM_TOL * scale + 1e-30).all(), f"{what}: {gap.max().item()}"


# ---------------------------------------------------------------------------
# the kernels' index arithmetic
# ---------------------------------------------------------------------------
def visits(rows, channels, vec, sms):
    """How often the kernels' threads touch each (row, channel), walking
    blocks, threads and unrolled iterations as ``bias_act_fwd`` does."""
    threads, unroll = cuda_bias_act.THREADS, cuda_bias_act.UNROLL
    width, grid_x, grid_y = cuda_bias_act.geometry(rows, channels, vec, sms)
    seen = np.zeros((rows, channels), np.int64)
    rows_per_pass = threads // width
    stride = grid_x * rows_per_pass
    for by in range(grid_y):
        for t in range(threads):
            lane, row = t % width, t // width
            c0 = (by * width + lane) * vec
            if row >= rows_per_pass or c0 >= channels:
                continue
            for bx in range(grid_x):
                for r in range(bx * rows_per_pass + row, rows, unroll * stride):
                    for u in range(unroll):
                        if r + u * stride < rows:
                            seen[r + u * stride, c0:c0 + vec] += 1
    return seen, (width, grid_x, grid_y)


@pytest.mark.parametrize("rows,channels,vec,sms", [
    (105, 3, 1, 2), (105, 32, 8, 2), (105, 1024, 8, 2), (33, 24, 8, 1), (2048, 64, 8, 132),
    (7, 4096, 8, 3), (1000, 5, 1, 1), (3, 1, 1, 132)])
def test_geometry_covers_every_element_once(rows, channels, vec, sms):
    seen, (width, grid_x, grid_y) = visits(rows, channels, vec, sms)
    assert (seen == 1).all(), np.argwhere(seen != 1)[:5]
    assert 1 <= width <= cuda_bias_act.THREADS and grid_y <= 65535
    assert grid_x * grid_y <= max(cuda_bias_act.BLOCKS_PER_SM * sms, grid_y)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------
def run_block(act, dtype, channels, fused, monkeypatch):
    """A 3x3 conv block from 2 to ``channels`` channels over an odd 3 x 5 x
    7 map of rows on the NHWC route, its output and the gradients of the
    input, the kernel and the bias, and the counters of the forward."""
    route_on(monkeypatch)
    if not fused:
        fused_off(monkeypatch)
    layer = Layer({"name": "c", "op": "c", "out": channels, "kernel": 3, "act": act},
                  (2, 5, 7), name_prefix="t/", compute_dtype=dtype)
    p, s = layer.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    params = tree_map(lambda t: (torch.randn(t.shape, generator=g) * 0.3).requires_grad_(True), p)
    x = torch.randn(3, 2, 5, 7, generator=g).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    (y, _), counts = counted(lambda: layer.apply(params, s, x))
    ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad((y.float() * ct).sum(), [x, params["kernel"]["kernel"],
                                                        params["bias"]["bias"]])
    return y, grads, counts


@pytest.mark.parametrize("channels", [3, 32, 1024])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_fused_block_matches_plain(act, dtype, channels, monkeypatch):
    y, (gx, gk, gb), on = run_block(act, DTYPES[dtype], channels, True, monkeypatch)
    y0, (gx0, gk0, gb0), off = run_block(act, DTYPES[dtype], channels, False, monkeypatch)
    assert on == {"layout.nhwc_conv": 1, "fuse.bias_act": 1}, on
    assert off == {"layout.nhwc_conv": 1, "fuse.bias_act_plain": 1}, off
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert_equal(y, y0, "output")
    assert_equal(gx, gx0, "input gradient")
    assert_equal(gk, gk0, "kernel gradient")
    assert gb.dtype == torch.float32
    # the bias's terms are the output's gradient times act' <= 1, each rounded
    ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    assert_sum_close(gb, gb0, 1.01 * ct, "bias gradient")


def test_plain_versions_are_the_plain_ops():
    """``bias_act_plain`` and its backward against autograd of the ops a
    plain block runs, over an odd channels_last bf16 map."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 5, 7, 9, generator=g).bfloat16().contiguous(
        memory_format=torch.channels_last)
    bias = torch.randn(5, generator=g)
    ct = torch.randn(x.shape, generator=g).bfloat16().contiguous(memory_format=torch.channels_last)
    for act in ACTS:
        xr, br = x.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        want = layers.apply_activation((xr + ops.per_channel(br, xr, torch.float32)).to(x.dtype),
                                       act)
        want_gx, want_gb = torch.autograd.grad(want, (xr, br), ct)
        y = ops.bias_act_plain(x, bias, act)
        gx, gb = ops.bias_act_plain_backward(ct, y, act, True)
        assert_equal(y, want.detach(), act)
        assert_equal(gx, want_gx, act)
        assert_sum_close(gb, want_gb, gx, act)
        assert ops.bias_act_plain_backward(ct, y, act, False)[1] is None


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="elu"):
        cuda_bias_act.bias_act(torch.zeros(1, 2, 2, 2), torch.zeros(2), "elu")


def double_backward(fn, act, dtype, dev):
    """[gx, gb, x's second, the bias's second, ct's second] of ``fn(x,
    bias, act)`` over an odd seeded map: the gradients of x and the bias by
    ``ct`` with ``create_graph``, then those of x, the bias and ``ct`` by a
    seeded weighting of both (None as zeros)."""
    g = torch.Generator().manual_seed(4)
    cl = dict(memory_format=torch.channels_last)
    shape = (3, 24, 5, 7)
    x = (torch.randn(shape, generator=g) * 2).to(dtype).contiguous(**cl).to(dev)
    bias = torch.randn(shape[1], generator=g).to(dev)
    ct = torch.randn(shape, generator=g).to(dtype).contiguous(**cl).to(dev)
    w, v = torch.randn(shape, generator=g).to(dev), torch.randn(shape[1], generator=g).to(dev)
    x, bias, ct = (t.requires_grad_(True) for t in (x, bias, ct))
    gx, gb = torch.autograd.grad(fn(x, bias, act), (x, bias), ct, create_graph=True)
    second = torch.autograd.grad((gx.float() * w).sum() + (gb * v).sum(), (x, bias, ct),
                                 allow_unused=True)
    return [t.detach() for t in [gx, gb] + [
        torch.zeros_like(t) if d is None else d for t, d in zip((x, bias, ct), second)]]


def assert_double_backward_equal(got, want):
    gx, gb, x2, b2, ct2 = got
    assert_equal(gx, want[0], "gradient")
    assert_equal(x2, want[2], "x's second")
    assert_equal(ct2, want[4], "ct's second")
    assert_sum_close(gb.cpu(), want[1].cpu(), gx.cpu(), "bias")
    assert_sum_close(b2.cpu(), want[3].cpu(), x2.cpu(), "bias's second")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_double_backward_matches_plain(act, dtype, monkeypatch):
    """A backward taken with ``create_graph`` through ``BiasAct`` and
    differentiated again through ``BiasActGrad``'s closed form, the
    launchers standing in by the plain ops, against autograd of the plain
    ops; the second backward launches the backward again and no plain op."""
    made = route_on(monkeypatch)
    got = double_backward(cuda_bias_act.bias_act, act, DTYPES[dtype], "cpu")
    # tanh's second reaches y, so BiasAct's backward runs once more
    assert made == [1, 3 if act == "tanh" else 2], made
    want = double_backward(ops.bias_act_plain, act, DTYPES[dtype], "cpu")
    assert_double_backward_equal(got, want)
    if act == "tanh":   # y's gradient reaches x
        assert got[2].abs().sum() > 0


# ---------------------------------------------------------------------------
# whole networks and a train step
# ---------------------------------------------------------------------------
NETWORKS = {"cifar10": (cifar_architecture, 2), "celeba64": (celeba_architecture, 2),
            "hd512": (lambda: hd_architecture(512), 1)}


@pytest.mark.parametrize("config", sorted(NETWORKS))
def test_fused_networks_match_plain(config, monkeypatch):
    """G on seeded codes, D on concat(fake, fake reversed), then the
    gradients of the scores by every parameter: fused against plain on the
    NHWC route, bf16; every D conv block and G's last block fused."""
    arch_fn, n = NETWORKS[config]
    route_on(monkeypatch)
    model = SNGan(arch_fn(), device="cpu", compute_dtype=torch.bfloat16)
    p, state, _ = model.init(0)
    fusable = [l for l in model.Dis.layers + model.Gen.layers if l.fused_act is not None]
    assert [l.fused_act for l in fusable] == ["lrelu"] * (len(model.Dis.layers) - 1) + ["tanh"]
    z = torch.randn(n, model.code_size, generator=torch.Generator().manual_seed(1))

    def run():
        params = tree_map(lambda t: t.clone().requires_grad_(True), p)

        def forward():
            gen_x, _ = model.Gen.apply(params["gen"], state["gen"], z, train=True)
            scores, _ = model.Dis.apply(params["dis"], state["dis"],
                                        torch.cat([gen_x, gen_x.flip(0)]), train=True)
            return gen_x, scores
        (gen_x, scores), counts = counted(forward)
        ct = torch.randn(scores.shape, generator=torch.Generator().manual_seed(3))
        grads = torch.autograd.grad((scores.float() * ct).sum(), tree_leaves(params))
        return [gen_x, scores] + list(grads), counts

    got, on = run()
    fused_off(monkeypatch)
    want, off = run()
    assert on["fuse.bias_act"] == len(fusable) and "fuse.bias_act_plain" not in on, on
    assert off["fuse.bias_act_plain"] == len(fusable) and "fuse.bias_act" not in off, off
    names = ["images", "scores"] + [f"gradient {i}" for i in range(len(want) - 2)]
    for what, g, w in zip(names, got, want):
        assert_equal(g, w, what)


NARROW = {   # the CIFAR layer kinds at 1/8 of the channels, 16x16
    "input": [(3, 16, 16)],
    "code": [(128, "linear")],
    "generator": [
        {"name": "l1", "out": 64 * 2 * 2, "op": "d", "act": "linear", "act_nm": None,
         "out_reshape": [64, 2, 2]},
        {"name": "l2_up", "out": 32, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3_up", "out": 16, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l4_up", "out": 8, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l5_t16", "out": 3, "act": "tanh"},
    ],
    "discriminator": [
        {"name": n, "out": c, "act": "lrelu", "act_k": 1.3, "w_nm": "s", **kw}
        for n, c, kw in (("l1_f16", 8, {}), ("l2_ds", 16, {"kernel": 4, "strides": 2}),
                         ("l3", 16, {}), ("l4_ds", 32, {"kernel": 4, "strides": 2}),
                         ("l5", 32, {"out_reshape": [32 * 4 * 4]}))
    ] + [{"name": "l6_s", "out": 16, "op": "d", "act_k": 1.3, "w_nm": "s"}],
}


@pytest.mark.parametrize("loss_type", ["rep", "rep_gp"])
def test_train_step_matches_plain(loss_type, monkeypatch):
    """Two bf16 train steps of a narrow model, fused against plain on the
    NHWC route; ``rep_gp``'s penalty differentiates D's input gradient
    again (a double backward through the fused blocks: ``BiasActGrad``'s
    closed form). Metrics and the whole state after the steps bitwise
    equal."""
    route_on(monkeypatch)
    batches = np.random.RandomState(0).randn(2, 8, 16, 16, 3).clip(-1, 1).astype(np.float32)

    def run():
        model = SNGan(NARROW, loss_type=loss_type, compute_dtype=torch.bfloat16, device="cpu")
        opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
        ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
        step = build_train_step(model, opt_d, opt_g, device="cpu")
        for x in batches:
            ts, m = step(ts, {"x": x})
        return ts, m

    ts, m = run()
    fused_off(monkeypatch)
    ts0, m0 = run()
    assert list(m) == list(m0)
    for k in m0:
        assert_equal(m[k], m0[k], k)
    for i, (a, b) in enumerate(zip(ts.tensors(), ts0.tensors())):
        assert_equal(a, b, f"state tensor {i}")


STEPS = {   # (the build_* function, the accumulated step's M)
    "fused": (lambda model, od, og: build_train_step(model, od, og, device="cpu"), 1),
    "accumulated": (lambda model, od, og: build_grad_accum_step(model, od, og, 2, device="cpu"),
                    2),
    "imbalanced": (lambda model, od, og: build_imbalanced_multi_step(
        model, od, og, 1, [1, 5], device="cpu"), 1),
}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_train_step_launches_as_chip_smoke_counts(kind, monkeypatch):
    """One rep step of the narrow model makes the launches that
    ``chip_smoke.py``'s ``bias_act_per_step`` expects, which the card's
    counters must equal in every counted window: the fused step, the
    accumulated step at M = 2 and an imbalanced [1, 5] window of one
    step."""
    import chip_smoke

    made = route_on(monkeypatch)
    build, micro = STEPS[kind]
    model = SNGan(NARROW, loss_type="rep", compute_dtype=torch.bfloat16, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    step = build(model, opt_d, opt_g)
    x = np.random.RandomState(0).randn(8, 16, 16, 3).clip(-1, 1).astype(np.float32)
    if kind == "imbalanced":
        step(ts, {"x": x[None]}, None, torch.zeros(()))
    else:
        step(ts, {"x": x})
    assert made == chip_smoke.bias_act_per_step(model, micro) == [
        2 * micro * 6 if micro > 1 else 6, micro * 11], made


# ---------------------------------------------------------------------------
# where the route is off
# ---------------------------------------------------------------------------
ROUTE_OFF = {
    # (design, compute dtype, route forced on, counter the block adds)
    "float32": ({"op": "c", "out": 4, "act": "lrelu"}, torch.float32, True, "fuse.bias_act_plain"),
    "cpu_default": ({"op": "c", "out": 4, "act": "tanh"}, torch.bfloat16, False,
                    "fuse.bias_act_plain"),
    "bn": ({"op": "c", "out": 4, "act": "relu", "act_nm": "bn"}, torch.bfloat16, True, None),
    "no_bias": ({"op": "c", "out": 4, "act": "relu", "bias": False}, torch.bfloat16, True, None),
    "elu": ({"op": "c", "out": 4, "act": "elu"}, torch.bfloat16, True, None),
    "res": ({"type": "res", "op": "c", "out": 4, "act": "relu", "kernel": [3, 3, 1]},
            torch.bfloat16, True, None),
}


@pytest.mark.parametrize("case", sorted(ROUTE_OFF))
def test_route_is_off(case, monkeypatch):
    """Float32 compute and the CPU's own default keep the plain ops (and
    count them); blocks with BN, without a plain bias, with another
    activation, or of another type are not fused by design."""
    design, dtype, forced, counter = ROUTE_OFF[case]
    if forced:
        route_on(monkeypatch)
    calls = []
    monkeypatch.setattr(cuda_bias_act, "bias_act", lambda *a: calls.append(a))
    layer = Layer({"name": "c", **design}, (4, 5, 7), compute_dtype=dtype)
    assert (layer.fused_act is None) == (counter is None)
    p, s = layer.init(torch.Generator().manual_seed(0))
    x = torch.randn(3, 4, 5, 7).contiguous(memory_format=torch.channels_last)
    (y, _), counts = counted(lambda: layer.apply(p, s, x))
    assert calls == [] and y.dtype == dtype
    fuse = {k: v for k, v in counts.items() if k.startswith("fuse.")}
    assert fuse == ({} if counter is None else {counter: 1}), counts


def test_route_is_off_for_a_dense_layer_and_under_export(monkeypatch):
    route_on(monkeypatch)
    dense = Layer({"name": "d", "op": "d", "out": 4, "act": "lrelu"}, (6,))
    assert dense.fused_act is None
    x = torch.zeros(2, 3, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    assert ops.bias_act_route(x, torch.bfloat16)
    assert not ops.bias_act_route(x, torch.float16)           # another compute dtype
    assert not ops.bias_act_route(x.contiguous(), torch.bfloat16)   # NCHW memory
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert not ops.bias_act_route(x, torch.bfloat16)


def test_exported_generator_holds_no_fused_call(tmp_path, monkeypatch):
    """The narrow generator exported in bf16 with the route forced on: no
    fused call while ``torch.export`` traces, none in the program, and its
    images equal ``generate``'s, which fuses the tanh block."""
    from mmdgan_torch.utils.export import export_generator, load_exported

    route_on(monkeypatch)
    calls = []
    fused = cuda_bias_act.bias_act
    monkeypatch.setattr(cuda_bias_act, "bias_act", lambda *a: calls.append(a) or fused(*a))
    model = SNGan(NARROW, compute_dtype=torch.bfloat16, device="cpu")
    params, state, _ = model.init(0)
    path = export_generator(model, params, state, 4, str(tmp_path / "g.pt2"), device="cpu")
    assert calls == []
    program = torch.export.load(path)
    assert "BiasAct" not in str(program.graph) and "bias_act" not in str(program.graph)
    z = torch.randn(4, model.code_size, generator=torch.Generator().manual_seed(1))
    got = load_exported(path, device="cpu")(z)
    want = model.generate(params, state, code_batch={"x": z, "y": None})
    assert len(calls) == 1 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
CARD_SHAPES = [(3, 32, 17, 19), (2, 3, 64, 64), (2, 1024, 4, 4), (5, 24, 7, 9)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_inputs(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    cl = dict(memory_format=torch.channels_last)
    x = (torch.randn(shape, generator=g) * 2).to(dtype).contiguous(**cl).to(dev)
    bias = torch.randn(shape[1], generator=g).to(dev)
    ct = torch.randn(shape, generator=g).to(dtype).contiguous(**cl).to(dev)
    return x, bias, ct


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_card_kernel_pair_matches_plain_ops(act, dtype, shape):
    """The kernels against autograd of the plain ops on the card: the output
    and the input's gradient bitwise, the bias's gradient within float32
    rounding; two backward launches bitwise equal."""
    dev = _card()
    x, bias, ct = _card_inputs(shape, DTYPES[dtype], dev, 5)
    xr, br = x.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    want = ops.bias_act_plain(xr, br, act)
    want_gx, want_gb = torch.autograd.grad(want, (xr, br), ct)
    y = cuda_bias_act.bias_act_forward_cuda(x, bias, act)
    gx, gb = cuda_bias_act.bias_act_backward_cuda(ct, y, act, True)
    gx2, gb2 = cuda_bias_act.bias_act_backward_cuda(ct, y, act, True)
    torch.cuda.synchronize()
    assert_equal(y, want.detach(), "output")
    assert_equal(gx, want_gx, "input gradient")
    assert_sum_close(gb.cpu(), want_gb.cpu(), gx.cpu(), "bias gradient")
    assert torch.equal(gx2, gx) and torch.equal(gb2, gb)
    assert cuda_bias_act.bias_act_backward_cuda(ct, y, act, False)[1] is None


@pytest.mark.card
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_card_double_backward_matches_plain_ops(act, dtype):
    """A double backward through the kernels against autograd of the plain
    ops on the card, as the CPU case runs it through the stand-ins."""
    dev = _card()
    got = double_backward(cuda_bias_act.bias_act, act, DTYPES[dtype], dev)
    want = double_backward(ops.bias_act_plain, act, DTYPES[dtype], dev)
    torch.cuda.synchronize()
    assert_double_backward_equal(got, want)


@pytest.mark.card
def test_card_kernel_pair_replays_in_a_graph():
    """Forward and backward captured in one CUDA graph: three replays
    bitwise equal to the eager launches."""
    dev = _card()
    x, bias, ct = _card_inputs((4, 64, 16, 16), torch.bfloat16, dev, 6)
    eager = [cuda_bias_act.bias_act_forward_cuda(x, bias, "lrelu")]
    eager += cuda_bias_act.bias_act_backward_cuda(ct, eager[0], "lrelu", True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up off the capture
        cuda_bias_act.bias_act_backward_cuda(ct, cuda_bias_act.bias_act_forward_cuda(
            x, bias, "lrelu"), "lrelu", True)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = cuda_bias_act.bias_act_forward_cuda(x, bias, "lrelu")
        out = [y, *cuda_bias_act.bias_act_backward_cuda(ct, y, "lrelu", True)]
    for _ in range(3):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(out, eager):
            assert torch.equal(got, want)
