"""The conv layout route (``mmdgan_torch/models/ops.py`` ``nhwc_route``):
on the card under 16-bit compute every conv op takes its input and kernels
channels_last, so cuDNN's NHWC engines run without transposes around them.

On the CPU the route is taken through the helper's internal argument
(``_any_device``). Each case runs one layer, block or whole network twice
in bfloat16, the route off and on, from the same parameters and input:
outputs, the input's gradient and every parameter's gradient agree within
four bfloat16 ulps of the largest entry (the two layouts sum in other
orders). Through the whole cifar10 networks a sum that rounds otherwise
flips bfloat16 roundings downstream, so there the route may move a result
as far as bfloat16 compute itself moves it from float32, and no further,
and, where bfloat16 resolves the result at all, never past ten times the
per-layer bound (``ROUTE_CAP``);
with the route on, image outputs come back channels_last and the float32
parameters' gradients contiguous, as the optimizer's fused multi-tensor
updates need.

The ``card`` tests need a CUDA card and skip here; on the card, without
the JAX test configuration: ``python -m pytest --noconftest
tests/test_torch_layout.py -m card``.
"""

import functools
import os
import runpy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmdgan_torch.architectures import cifar_architecture
from mmdgan_torch.models import ops
from mmdgan_torch.models.layers import Layer
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.tools.profile_step import raw_activities
from mmdgan_torch.train.state import tree_leaves, tree_map
from mmdgan_torch.utils import spans
from test_torch_bias_act import plain_launchers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 4 * 2.0 ** -8   # four bfloat16 ulps, relative to the largest entry
# The whole cifar10 networks' cap, in BF16_TOL, on every result that
# bfloat16 resolves (moves by less than half its size from float32): on the
# CPU the route moved those at most 5.6 BF16_TOL (scores' gradients) and
# 6.8 (the penalty's), where bfloat16 moved them up to 21 and 11.5. Three of
# the penalty's gradients (the initial D's input gradient is about 1e-15)
# are rounding noise, which bfloat16 moves by up to 1.05 of their size and
# the route by 0.28: those are held to bfloat16's own gap.
ROUTE_CAP = 10
N = 4


def _sn(**kw):
    return {"w_nm": "s", "act_k": 1.3, **kw}


# (design, per-example input shape (C, H, W), classes)
LAYERS = {
    "c_same": ({"name": "c", "op": "c", "out": 8, "kernel": 3, "act": "lrelu", **_sn()},
               (3, 8, 8), 0),
    "c_valid": ({"name": "c", "op": "c", "out": 4, "kernel": 3, "padding": "VALID",
                 **_sn()}, (3, 7, 7), 0),
    "c_strided": ({"name": "c", "op": "c", "out": 8, "kernel": 3, "strides": 2, **_sn()},
                  (3, 8, 8), 0),
    "c_dilated": ({"name": "c", "op": "c", "out": 4, "kernel": 3, "dilation": 2, **_sn()},
                  (3, 6, 6), 0),
    "tc": ({"name": "t", "op": "tc", "out": 4, "kernel": 4, "strides": 2, "act": "relu",
            "act_nm": "bn", **_sn()}, (6, 4, 4), 0),
    "cck": ({"name": "c", "op": "cck", "out": 4, "kernel": 3, **_sn()}, (3, 6, 6), 3),
    "tcck": ({"name": "t", "op": "tcck", "out": 3, "kernel": 4, "strides": 2, **_sn()},
             (4, 3, 3), 3),
    "cbn": ({"name": "c", "op": "c", "out": 4, "kernel": 3, "act": "relu", "act_nm": "cbn",
             **_sn()}, (3, 6, 6), 3),
    "cb": ({"name": "c", "op": "c", "out": 4, "kernel": 3, "bias": "cb", **_sn()},
           (3, 6, 6), 3),
    "bcb": ({"name": "t", "op": "tc", "out": 4, "kernel": 4, "strides": 2, "bias": "bcb",
             **_sn()}, (6, 4, 4), 3),
    "sc": ({"name": "sc", "op": "sc", "out": 5, "kernel": 3, "strides": 2, "act": "relu"},
           (3, 6, 6), 0),
    "max_after_c": ({"name": "s", "op": "c", "out": 4, "act": "relu", "scale": ["max", -2]},
                    (8, 4, 4), 0),
    "avg_after_c": ({"name": "s", "op": "c", "out": 4, "act": "relu", "scale": ["avg", -2]},
                    (8, 4, 4), 0),
    "res": ({"name": "r", "type": "res", "op": "tc", "out": 4, "act": "relu", "act_nm": "bn",
             "kernel": [4, 3, 4], "strides": [2, 1, 2], **_sn()}, (3, 4, 4), 0),
    "nl": ({"name": "nl", "type": "nl_pool", "op": "c", "out": [2, 2, 8], "kernel": [1, 1, 1],
            "act": "linear", "act_nm": "bn", **_sn()}, (8, 4, 4), 0),
}


def route_on(monkeypatch):
    """The NHWC route on the CPU; the fused bias-activation blocks it takes
    run the plain ops in place of the kernels (``plain_launchers``)."""
    monkeypatch.setattr(ops, "nhwc_route", functools.partial(ops.nhwc_route, _any_device=True))
    plain_launchers(monkeypatch)


def randomized(tree, seed):
    """Seeded values in the shapes of a params or state tree (tables and
    scales non-zero, variances positive), as float32 leaves."""
    g = torch.Generator().manual_seed(seed)

    def fill(t):
        v = torch.randn(t.shape, generator=g) * 0.5
        return v.abs() + 0.5 if t.dim() == 1 and bool((t == 1).all()) else v
    return tree_map(fill, tree)


def assert_close(got, want, what, tol=BF16_TOL):
    scale = want.float().abs().max().item()
    gap = (got.float() - want.float()).abs().max().item()
    assert gap <= tol * scale, f"{what}: {gap} against {scale}"


def run_layer(case, nhwc, monkeypatch):
    design, ish, num_class = LAYERS[case]
    if nhwc:
        route_on(monkeypatch)
    layer = Layer(design, ish, name_prefix="t/", num_class=num_class,
                  compute_dtype=torch.bfloat16)
    p, s = layer.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.requires_grad_(True), randomized(p, 1))
    state = randomized(s, 2)
    x = torch.randn((N,) + ish, generator=torch.Generator().manual_seed(3))
    if nhwc:   # as the layer before it hands it over on the route
        x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    label = torch.arange(N) % num_class if num_class else None
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out, _ = layer.apply(params, state, x, train=True, label=label)
    counted = spans.counters()
    spans.clear()
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    grads = torch.autograd.grad((out.float() * ct).sum(), [x] + tree_leaves(params))
    return layer, out, grads, counted


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_route_keeps_layer_results(case, monkeypatch):
    layer, want, want_grads, off = run_layer(case, False, monkeypatch)
    _, got, grads, on = run_layer(case, True, monkeypatch)
    convs = sum(isinstance(op, ops.ParametricOp) and op.geometry is not None
                and op.design["op"] not in ("max", "avg", "sum") for op in layer.ops.values())
    fused = {} if layer.fused_act is None else {"fuse.bias_act": 1}
    plain = {} if layer.fused_act is None else {"fuse.bias_act_plain": 1}
    assert convs > 0 and off == {"layout.nchw_conv": convs, **plain}
    assert on == {"layout.nhwc_conv": convs, **fused}
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert_close(got, want, "output")
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.is_contiguous() or i == 0, f"gradient {i} is not contiguous"
        assert_close(g, w, f"gradient {i}")


def run_cifar(nhwc, monkeypatch, penalty=False, dtype=torch.bfloat16):
    """G on seeded codes, then D on concat(real, fake) as the train step
    feeds it (the real batch a channels_last view of NHWC rows, as
    ``to_nchw`` makes it), D's flattened features before its dense head,
    and the gradients of the scores (or, with ``penalty``, of the
    gradient penalty's norm, a double backward) by every parameter."""
    if nhwc:
        route_on(monkeypatch)
    model = SNGan(cifar_architecture(), device="cpu", compute_dtype=dtype)
    p, state, _ = model.init(0)
    params = tree_map(lambda t: t.clone().requires_grad_(True), p)
    z = torch.randn(N, model.code_size, generator=torch.Generator().manual_seed(1))
    gen_x, _ = model.Gen.apply(params["gen"], state["gen"], z, train=True)
    rows = torch.rand(N, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    x = torch.cat([rows.permute(0, 3, 1, 2), gen_x])
    if penalty:
        x = x.detach().requires_grad_(True)
    h = x
    for layer in model.Dis.layers[:-1]:
        h, _ = layer.apply(params["dis"][layer.layer_scope], state["dis"][layer.layer_scope], h)
    scores, _ = model.Dis.apply(params["dis"], state["dis"], x, train=True)
    out = scores
    if penalty:
        (g,) = torch.autograd.grad(scores.sum(), x, create_graph=True)
        out = torch.sqrt(torch.sum(torch.square(g.reshape(2 * N, -1)), dim=1))
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    grads = torch.autograd.grad((out * ct).sum(), tree_leaves(params), allow_unused=True)
    return gen_x, h, scores, grads


@pytest.mark.parametrize("penalty", [False, True], ids=["scores", "penalty"])
def test_route_keeps_cifar_generator_and_discriminator(penalty, monkeypatch):
    exact = run_cifar(False, monkeypatch, penalty, torch.float32)
    want = run_cifar(False, monkeypatch, penalty)
    got = run_cifar(True, monkeypatch, penalty)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    # the flatten before D's dense head keeps the NCHW order of its kernel
    assert got[1].shape == (2 * N, 4 * 4 * 512) and got[1].is_contiguous()
    names = ["images", "features", "scores"] + [f"gradient {i}" for i in range(len(got[3]))]
    for what, g, w, f in zip(names, got[:3] + got[3], want[:3] + want[3], exact[:3] + exact[3]):
        if w is None:
            assert g is None and f is None
            continue
        if g is None:   # the fused blocks pass no gradient where the plain ops pass zeros
            assert not w.any() and not f.any(), f"{what}: none on the route"
            continue
        assert g.is_contiguous() or what == "images", f"{what} is not contiguous"
        # no further from bfloat16's result than bfloat16 is from float32
        bf16_gap = (w.float() - f).abs().max().item() / max(f.abs().max().item(), 1e-30)
        tol = max(bf16_gap, BF16_TOL)
        assert_close(g, w, what, tol if bf16_gap >= 0.5 else min(tol, ROUTE_CAP * BF16_TOL))


def test_route_follows_device_and_compute_dtype():
    x = torch.zeros(1, 3, 4, 4)
    assert not ops.nhwc_route(x, torch.bfloat16)
    assert ops.nhwc_route(x, torch.bfloat16, _any_device=True)
    assert ops.nhwc_route(x, torch.float16, _any_device=True)
    assert not ops.nhwc_route(x, torch.float32, _any_device=True)


def test_channel_sum_and_broadcast_are_adjoint():
    """The GEMV channel sum over a channels_last map and its broadcast:
    first and second derivatives (the penalties' double backward) by finite
    differences in float64; the sum equals the plain one."""
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64).contiguous(memory_format=torch.channels_last)
    v = torch.randn(3, dtype=torch.float64)
    assert ops._nhwc_map(x)
    assert torch.allclose(ops._ChannelSum.apply(x), x.sum((0, 2, 3)))
    x.requires_grad_(True)
    v.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: ops._ChannelSum.apply(t * t), (x,))
    assert torch.autograd.gradgradcheck(lambda t: ops._ChannelSum.apply(t * t), (x,))
    bcast = lambda u: ops._ChannelBroadcast.apply(u, x.shape) * x   # noqa: E731
    assert torch.autograd.gradcheck(bcast, (v,)) and torch.autograd.gradgradcheck(bcast, (v,))


class _OneRank:
    """A mesh of one rank (its ``all_reduce`` is the identity)."""
    size = 1


@pytest.mark.parametrize("mode", ["train", "eval", "mesh"])
def test_batch_norm_on_the_route(mode, monkeypatch):
    """BN on the route against BN off it, on the same channels_last map:
    ``torch.native_batch_norm`` in train and eval mode, and with a mesh (one
    rank) ``batch_moments``' GEMV sums. Outputs and the map's gradient
    within four bfloat16 ulps; the moving statistics' steps and gamma's and
    beta's gradients within float32 rounding."""
    if mode == "mesh":
        monkeypatch.setattr(ops, "all_reduce", lambda t, dp: t)
    op = ops.ParametricOp({"op": "bn"}, (6, 5, 3), compute_dtype=torch.bfloat16)
    p, s = op.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.requires_grad_(True), randomized(p, 1))
    state = randomized(s, 2)
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 6, 5, 3, generator=g) * 2 + 1).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    ct = torch.randn(x.shape, generator=g)
    results = []
    for nhwc in (False, True):
        if nhwc:
            route_on(monkeypatch)
        y, new = op.apply(params, state, x, train=mode != "eval",
                          dp=_OneRank() if nhwc and mode == "mesh" else None)
        grads = torch.autograd.grad((y.float() * ct).sum(), [x] + tree_leaves(params))
        moved = [new[k] - state[k] for k in ("moving_mean", "moving_var")]
        results.append([y, grads[0]] + moved + list(grads[1:]))
    names = ["output", "map gradient", "moving mean's step", "moving var's step", "gamma gradient",
             "beta gradient"]
    for i, (what, got, want) in enumerate(zip(names, results[1], results[0])):
        assert_close(got, want, what, BF16_TOL if i < 2 else 1e-5)


def test_kernel_cast_is_one_copy_each_way():
    """``_NhwcKernel``: a channels_last bfloat16 kernel whose gradient
    comes back float32 and contiguous; without a gradient to carry, the
    same cast (what ``torch.export`` traces)."""
    w = torch.randn(8, 4, 3, 3, requires_grad=True)
    k = ops._NhwcKernel.apply(w, torch.bfloat16)
    assert k.dtype == torch.bfloat16 and k.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(k.float(), w.detach().bfloat16().float())
    ct = torch.randn(8, 4, 3, 3).bfloat16().contiguous(memory_format=torch.channels_last)
    (g,) = torch.autograd.grad((k * ct).sum(), w)
    assert g.dtype == torch.float32 and g.is_contiguous() and torch.equal(g, ct.float())
    with torch.no_grad():
        k = ops._NhwcKernel.apply(w, torch.bfloat16)
    assert k.grad_fn is None and k.is_contiguous(memory_format=torch.channels_last)


def _cifar_agent_call(tmp_path, profiled):
    """Two ``train_device_data`` calls of cifar10 at b64, bf16, K = 16; the
    second (a fresh capture of its window, then replays) under ``profiled``."""
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import init_train_state
    from mmdgan_torch.train.trainer import Agent

    model = SNGan(cifar_architecture(), loss_type="rep", compute_dtype=torch.bfloat16)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g)
    data = {"x": np.random.RandomState(0).randint(0, 256, (2048, 32, 32, 3), dtype=np.uint8),
            "y": None}
    agent = Agent("layout", "run", do_save=False, output_dir=str(tmp_path),
                  use_tensorboard=False, print_loss=False)
    kw = dict(step_per_epoch=32, batch_size=64, steps_per_call=16)
    ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=16, seed=1, **kw)
    with profiled:
        ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=48, seed=2, **kw)
        torch.cuda.synchronize()
    return model, ts


@pytest.mark.card
def test_card_window_runs_no_16_bit_transpose(tmp_path):
    """A captured K = 16 window of cifar10 at b64 in bf16 under the
    profiler: no kernel that the benchmark's transpose reader matches runs
    on bfloat16 data, and every conv took the NHWC route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spans.clear()
    pattern = runpy.run_path(os.path.join(
        REPO, "benchmark", "metrics", "layout_transpose_ms_per_step.train.py"))["PATTERNS"]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, ts = _cifar_agent_call(tmp_path, prof)
    assert int(ts.step) == 64
    assert all(torch.isfinite(t.float()).all() for t in ts.tensors())
    kernels = {name for name, _, _ in raw_activities(prof, torch.autograd.DeviceType.CUDA)}
    assert any("conv" in k.lower() or "gemm" in k.lower() for k in kernels), sorted(kernels)
    hits = sorted(k for k in kernels if pattern.search(k) and "bfloat16" in k.lower())
    assert hits == [], hits
    counted = spans.counters()
    spans.clear()
    assert counted.get("layout.nchw_conv", 0) == 0 and counted["layout.nhwc_conv"] > 0, counted


@pytest.mark.card
def test_card_exported_generator_equals_generate(tmp_path):
    """The exported cifar10 generator, traced on the card in bf16 (so it
    holds the channels_last casts), gives ``SNGan.generate``'s images
    bitwise, as on the CPU (``tests/test_torch_export.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmdgan_torch.utils.export import export_generator, load_exported

    model = SNGan(cifar_architecture(), loss_type="rep", compute_dtype=torch.bfloat16)
    params, state, _ = model.init(0)
    z = torch.randn(64, model.code_size, generator=torch.Generator().manual_seed(1)).cuda()
    fn = load_exported(export_generator(model, params, state, 64, str(tmp_path / "g.pt2")))
    got = fn(z)
    want = model.generate(params, state, code_batch={"x": z, "y": None})
    assert got.is_contiguous() and torch.equal(got, want)
