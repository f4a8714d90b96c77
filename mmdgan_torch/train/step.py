"""Train-step builders (``mmdgan_tpu/train/step.py:41-565,657-1246``).

- ``build_train_step``: one step. One generator forward and one
  discriminator forward on concat(real, fake). ``grads_dis`` comes from
  ``loss_dis``, ``grads_gen`` from ``loss_gen`` through the generated
  images; both are taken before either update. ``do_dis``/``do_gen`` gate
  the updates: a Python bool with an ``if``, so a skipped update leaves
  its optimizer slots untouched; a 0-d bool tensor on the device (the
  imbalanced window's flags, inside a CUDA graph) by selection
  (``Optimizer.gated_update_``), with the same result bit for bit. SN vectors
  and BN statistics update every step. The step updates the TrainState
  in place, every tensor in its own buffer, and returns it with the
  step's metrics as 0-d tensors on the device; reading them is the
  caller's choice, so the step itself never waits for the device.
- ``build_grad_accum_step``: the same step over a global batch run in M
  micro-batches, with exact global-batch MMD semantics.
- ``graph_steps``: K calls of a step as one CUDA graph launch, the
  counterpart of one ``lax.scan`` launch (``StepGraphs`` says how the
  graphs are made); on the CPU, or with ``capture=False``, an eager loop.
- ``build_multi_step``: ``graph_steps`` of the train step over a K-stacked
  batch.
- ``imbalanced_scan`` / ``build_imbalanced_multi_step``: K steps per
  launch whose update flags are computed on the device from the step
  count (a ``[d, g]`` period list) or from a uniform draw and the carried
  average of ``loss_gen`` (``'dynamic'``).
- ``build_device_data_step``: K steps whose batches are taken on the
  device from a dataset that lives there, the sampler inside the graph;
  it shares ``graph_steps``' window runner (``_window_runner``).
- ``EpochPermuter``: the per-epoch layouts of ``sampling='shuffled_epochs'``.
- ``build_eval_step``: eval-mode generation.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mmdgan_torch import DeviceLike, check_device
from mmdgan_torch.models.sngan import (
    DS_LOSSES,
    GP_LOSSES,
    SNGan,
    decode_image_batch,
    jacobian_squared_frobenius_norm,
    to_nchw,
)
from mmdgan_torch.train.optim import Optimizer
from mmdgan_torch.train.state import TrainState, copy_tree_, loss_state_leaves, tree_leaves


def init_train_state(model: SNGan, seed: int, opt_dis: Optimizer, opt_gen: Optimizer,
                     device: DeviceLike = None) -> TrainState:
    """Fresh state from ``seed``: the model's init and the step's z stream."""
    dev = check_device(model.device, device)
    params, net_state, loss_state = model.init(seed)
    return TrainState(
        params=params, net_state=net_state, loss_state=loss_state,
        opt_state_dis=opt_dis.init(params["dis"]),
        opt_state_gen=opt_gen.init(params["gen"]),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        rng=torch.Generator(dev).manual_seed(int(seed) + 1))


def _grads(out: torch.Tensor, inputs, retain_graph: bool = False,
           cotangent: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """d out / d inputs (the vector-Jacobian product with ``cotangent`` when
    given); zeros where ``out`` does not reach an input, and for a constant
    loss (the 'test' loss)."""
    if not out.requires_grad:
        return [torch.zeros_like(t) for t in inputs]
    grads = torch.autograd.grad(out, inputs, cotangent, retain_graph=retain_graph,
                                allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def _update(opt: Optimizer, do, leaves, grads, opt_state) -> None:
    """One optimizer update gated by ``do``: a Python bool by ``if``, a 0-d
    bool tensor (a flag on the device) by ``Optimizer.gated_update_``."""
    if isinstance(do, torch.Tensor):
        opt.gated_update_(leaves, grads, opt_state, do)
    elif do:
        opt.update_(leaves, grads, opt_state)


def build_train_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer,
                     device: DeviceLike = None) -> Callable:
    """Returns ``train_step(ts, data_batch, do_dis=True, do_gen=True,
    code_batch=None) -> (ts, metrics)``. ``data_batch['x']`` is NHWC
    ([B, H, W, C], float in [-1, 1] or uint8); ``code_batch={'x': z}``
    replaces the z draw, as ``gen_stage(code_batch=...)`` does in JAX. The
    step draws from the state's one generator in a fixed order: z, then
    the loss's draws, then the penalty's interpolation weights (JAX splits
    its key into ``rng_code``, ``rng_loss`` and ``rng_gp``)."""
    dev = check_device(model.device, device)

    def train_step(ts: TrainState, data_batch: Dict, do_dis: bool = True,
                   do_gen: bool = True, code_batch: Optional[Dict] = None):
        x = torch.as_tensor(data_batch["x"], device=dev)
        x = to_nchw(decode_image_batch({"x": x})["x"])
        gen_x, gen_state, _ = model.gen_stage(
            ts.params["gen"], ts.net_state, x.shape[0], ts.rng, code_batch)
        loss_gen, loss_dis, dis_state, new_loss_state, aux = model.dis_stage(
            ts.params["dis"], gen_x, ts.net_state, ts.loss_state, x, generator=ts.rng)
        dis_leaves = tree_leaves(ts.params["dis"])
        gen_leaves = tree_leaves(ts.params["gen"])
        grads_dis = _grads(loss_dis, dis_leaves, retain_graph=True)
        grads_gen = _grads(loss_gen, gen_leaves)
        _update(opt_dis, do_dis, dis_leaves, grads_dis, ts.opt_state_dis)
        _update(opt_gen, do_gen, gen_leaves, grads_gen, ts.opt_state_gen)
        # after both gradients: autograd saved the old SN vectors
        copy_tree_(ts.net_state, {"gen": gen_state, "dis": dis_state})
        with torch.no_grad():
            torch._foreach_copy_(loss_state_leaves(ts.loss_state),
                                 loss_state_leaves(new_loss_state))
            ts.step.add_(1)
        metrics = {"loss_gen": loss_gen.detach(), "loss_dis": loss_dis.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        if model.do_summary:
            metrics["grad_norm_dis"] = _global_norm(grads_dis)
            metrics["grad_norm_gen"] = _global_norm(grads_gen)
        return ts, metrics

    return train_step


def build_grad_accum_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer,
                          micro_batches: int, device: DeviceLike = None) -> Callable:
    """One optimizer step over a global batch run in M micro-batches
    (``mmdgan_tpu/train/step.py:157-473``): batches whose activations
    outgrow the card, at 1/M of the activation memory for about twice the
    forward work. Exact global-batch MMD semantics, not loss averaging
    (the MMD kernel matrices do not decompose over micro-batches):

    1. pass 1 runs G and D on each micro-batch without autograd and keeps
       only its [B/M, d] scores (and, for the penalties, the generated
       images);
    2. the penalty or scale pass: per micro-batch, the witness penalty
       (``*_gp``) and its gradient with respect to the D parameters and
       to the global scores, WGAN-GP's (``wasserstein``) with respect to
       the D parameters, or the Jacobian term of the scale (``*_ds``) and
       its D gradient, each summed over the micro-batches;
    3. the loss once, on the global scores, with the penalty or scale as
       differentiable inputs; two pulls give d loss_gen and d loss_dis by
       the scores (and by the penalty or scale). The kernel-means kernels
       run here: 1 forward and 2 backward launches per optimizer step,
       whatever M is;
    4. pass 2 recomputes each micro forward with autograd and pulls its
       slices of the score cotangents into the D and G gradients; the
       penalty's direct D gradient and its chain factor are added once.

    Returns ``train_step(ts, data_batch, do_dis=True, do_gen=True,
    code_batch=None, uni=None) -> (ts, metrics)``, the signature of
    ``build_train_step`` plus ``uni`` ([B, 1, 1, 1], the penalty's
    interpolation weights, drawn when not given). It draws from the
    state's generator in the fused step's order: all B rows of z, then
    the loss's draws, then all B rows of ``uni``, split per micro-batch;
    so at M=1, or on a model without BN, it equals the fused step up to
    summation order.

    With BN, train mode normalises each micro-batch by its own
    statistics, and the step's moving-statistic update is the average of
    the micro-batches' updates (every state leaf is averaged; the SN
    vectors are the same in every micro-batch)."""
    dev = check_device(model.device, device)
    m_count = int(micro_batches)
    if m_count < 1:
        raise ValueError(f"micro_batches must be >= 1, got {micro_batches}")
    loss_type = model.loss_type
    is_gp, is_w, is_ds = (loss_type in GP_LOSSES, loss_type == "wasserstein",
                          loss_type in DS_LOSSES)
    needs_gx = is_gp or is_w

    def micro_fwd(ts: TrainState, x: torch.Tensor, z: torch.Tensor):
        """Scores of concat(real, fake), real first; the new states; the
        generated images."""
        gen_x, gen_state = model.Gen.apply(ts.params["gen"], ts.net_state["gen"], z, train=True)
        scores, dis_state = model.Dis.apply(ts.params["dis"], ts.net_state["dis"],
                                            torch.cat([x, gen_x], dim=0), train=True)
        return scores, {"gen": gen_state, "dis": dis_state}, gen_x

    def train_step(ts: TrainState, data_batch: Dict, do_dis: bool = True, do_gen: bool = True,
                   code_batch: Optional[Dict] = None, uni: Optional[torch.Tensor] = None):
        x = torch.as_tensor(data_batch["x"], device=dev)
        x = to_nchw(decode_image_batch({"x": x})["x"])
        b = x.shape[0]
        if b % m_count:
            raise ValueError(f"a batch of {b} does not split into {m_count} micro-batches")
        z = model.sample_codes(ts.rng, b, None if code_batch is None else code_batch["x"])["x"]
        xs, zs = x.chunk(m_count), z.chunk(m_count)
        dis_leaves = tree_leaves(ts.params["dis"])
        gen_leaves = tree_leaves(ts.params["gen"])

        # pass 1: scores only (and the images the penalties interpolate)
        n = b // m_count
        s_xs, s_gens, gxs, gx_abs = [], [], [], []
        with torch.no_grad():
            for xm, zm in zip(xs, zs):
                scores, _, gen_x = micro_fwd(ts, xm, zm)
                s_xs.append(scores[:n])
                s_gens.append(scores[n:])
                if needs_gx:
                    gxs.append(gen_x)
                else:
                    gx_abs.append(torch.mean(torch.abs(gen_x)))
        # the global scores, leaves of the penalty's and the loss's pulls
        s_x, s_gen = torch.cat(s_xs).requires_grad_(True), torch.cat(s_gens).requires_grad_(True)
        gx_abs_mean = (torch.mean(torch.abs(torch.cat(gxs))) if needs_gx else
                       torch.mean(torch.stack(gx_abs)))
        draws = model.loss_hp.draw(loss_type, s_gen, ts.rng)

        # the penalty or scale pass, per micro-batch
        pen_in = scale_in = None
        if needs_gx:
            if uni is None:
                uni = torch.rand((b, 1, 1, 1), generator=ts.rng, device=dev)
            unis = torch.as_tensor(uni, dtype=torch.float32, device=dev).chunk(m_count)
            wrt = dis_leaves + ([s_x, s_gen] if is_gp else [])
            pen_sum, pen_gd = 0.0, [torch.zeros_like(t) for t in wrt]
            for xm, gxm, um in zip(xs, gxs, unis):
                if is_gp:
                    pen = model.mmd_gradient_penalty(ts.params["dis"], ts.net_state, xm, gxm,
                                                     s_x, s_gen, mode=loss_type, uni=um)
                else:
                    pen = model.gradient_penalty(ts.params["dis"], ts.net_state, xm, gxm, uni=um)
                torch._foreach_add_(pen_gd, _grads(pen, wrt))
                pen_sum = pen_sum + pen.detach()
            # the mean over B rows is the mean of the M equal micro means
            pen_in = (model.gp_weight * pen_sum / m_count).requires_grad_(True)
        elif is_ds:
            jaco_sum, pen_gd = 0.0, [torch.zeros_like(t) for t in dis_leaves]
            fwd = lambda xx: model._dis_fwd(ts.params["dis"], ts.net_state, xx)
            for xm in xs:
                jaco = torch.mean(jacobian_squared_frobenius_norm(fwd, xm))
                torch._foreach_add_(pen_gd, _grads(jaco, dis_leaves))
                jaco_sum = jaco_sum + jaco.detach()
            dis_scale = 1.0 / (model.penalty_weight * (jaco_sum / m_count) + 1.0)
            scale_in = dis_scale.requires_grad_(True)

        # the loss, once, on the global scores
        loss_gen, loss_dis, new_loss_state, loss_aux = model.loss_hp.apply(
            s_gen, s_x, loss_type, batch_size=b, d=model.score_size,
            dis_penalty=pen_in, dis_scale=scale_in, state=ts.loss_state, draws=draws)
        extra = [t for t in (pen_in, scale_in) if t is not None]
        cg_sg, cg_sx = _grads(loss_gen, [s_gen, s_x], retain_graph=True)
        cd_sg, cd_sx, *cd_extra = _grads(loss_dis, [s_gen, s_x] + extra)
        if needs_gx:
            w_pen = cd_extra[0] * model.gp_weight / m_count
        if is_gp:
            # the witness penalty's score cotangents ride pass 2's D pull
            cd_sx = cd_sx + w_pen * pen_gd[-2]
            cd_sg = cd_sg + w_pen * pen_gd[-1]
        cts_d = [torch.cat([a, g]) for a, g in zip(cd_sx.chunk(m_count), cd_sg.chunk(m_count))]
        cts_g = [torch.cat([a, g]) for a, g in zip(cg_sx.chunk(m_count), cg_sg.chunk(m_count))]

        # pass 2: each micro forward again, its cotangents pulled
        grads_dis = [torch.zeros_like(t) for t in dis_leaves]
        grads_gen = [torch.zeros_like(t) for t in gen_leaves]
        state_sum = [torch.zeros_like(t) for t in tree_leaves(ts.net_state)]
        for xm, zm, ct_d, ct_g in zip(xs, zs, cts_d, cts_g):
            scores, new_state, _ = micro_fwd(ts, xm, zm)
            torch._foreach_add_(grads_dis, _grads(scores, dis_leaves, True, ct_d))
            torch._foreach_add_(grads_gen, _grads(scores, gen_leaves, False, ct_g))
            torch._foreach_add_(state_sum, tree_leaves(new_state))
        if needs_gx:
            torch._foreach_add_(grads_dis, torch._foreach_mul(pen_gd[:len(dis_leaves)], w_pen))
        elif is_ds:
            # scale = 1 / (w mean + 1), so d scale / d mean = -w scale^2
            w_ds = cd_extra[0] * (-model.penalty_weight * dis_scale.detach() ** 2) / m_count
            torch._foreach_add_(grads_dis, torch._foreach_mul(pen_gd, w_ds))

        _update(opt_dis, do_dis, dis_leaves, grads_dis, ts.opt_state_dis)
        _update(opt_gen, do_gen, gen_leaves, grads_gen, ts.opt_state_gen)
        with torch.no_grad():
            torch._foreach_copy_(tree_leaves(ts.net_state), torch._foreach_div(state_sum, m_count))
            torch._foreach_copy_(loss_state_leaves(ts.loss_state),
                                 loss_state_leaves(new_loss_state))
            ts.step.add_(1)
        metrics = {"loss_gen": loss_gen.detach(), "loss_dis": loss_dis.detach(),
                   "s_x_mean": torch.mean(s_x.detach()), "s_gen_mean": torch.mean(s_gen.detach()),
                   "x_gen_abs_mean": gx_abs_mean, **{k: v.detach() for k, v in loss_aux.items()}}
        if model.do_summary:
            metrics["grad_norm_dis"] = _global_norm(grads_dis)
            metrics["grad_norm_gen"] = _global_norm(grads_gen)
        return ts, metrics

    return train_step


class StepGraphs:
    """CUDA graphs of a K-step window, one per key (the update flags and
    the inputs' shapes), all bound to the buffers they were captured on.

    A key's first call runs the window eagerly on a side stream, so that
    cuDNN's algorithm search, cuBLAS's workspace and the kernels' library
    load happen outside any capture. Its second call captures the window
    and replays the graph; every later call replays. The window's
    generators are registered with each graph, so every replay draws new
    numbers and advances the generator as an eager window would. A capture
    that fails raises. When the bound buffers change (another TrainState,
    another dataset tensor, another generator), every graph is dropped and
    the next calls warm up and capture anew.

    A graph's outputs are static: the next replay overwrites them, so the
    caller clones what it returns. ``eager``, ``captures`` and ``replays``
    count the three kinds of call."""

    def __init__(self):
        self._graphs: Dict = {}
        self._warm: set = set()
        self._binding = None
        self._pool = None
        self._stream = None
        self.eager = self.captures = self.replays = 0

    def run(self, key, bound: List[torch.Tensor], generators: List[torch.Generator],
            body: Callable):
        binding = (tuple(t.data_ptr() for t in bound), tuple(generators))
        if binding != self._binding:
            self._graphs.clear()
            self._warm.clear()
            self._binding = binding
        if key in self._graphs:
            graph, out = self._graphs[key]
            graph.replay()
            self.replays += 1
            return out
        if key not in self._warm:
            self._warm.add(key)
            return self._warm_up(body)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # thread_local: a data thread may pin host memory while this captures
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            out = body()
        self._graphs[key] = (graph, out)
        self.captures += 1
        graph.replay()
        self.replays += 1
        return out

    def _warm_up(self, body: Callable):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        current = torch.cuda.current_stream()
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = body()
        current.wait_stream(self._stream)
        for t in out[0]:
            t.record_stream(current)
        self.eager += 1
        return out


def _graphed(dev: torch.device, capture: Optional[bool]) -> bool:
    if capture is None:
        return dev.type == "cuda"
    if capture and dev.type != "cuda":
        raise ValueError(f"capture=True needs a state on CUDA, not {dev}")
    return bool(capture)


def _window(step: Callable, ts: TrainState, num_steps: int, batch_at: Callable,
            codes: Optional[torch.Tensor], do_dis: bool, do_gen: bool):
    """K steps; returns the [n_scalars, K] stacked scalar metrics, then one
    [K, nbins] stack per ``hist/*`` metric, then the keys of both."""
    per_step = []
    for k in range(num_steps):
        if codes is None:
            ts, m = step(ts, batch_at(k), do_dis, do_gen)
        else:
            ts, m = step(ts, batch_at(k), do_dis, do_gen, {"x": codes[k]})
        per_step.append(m)
    keys = tuple(k for k, v in per_step[0].items() if v.dim() == 0)
    hist_keys = tuple(k for k, v in per_step[0].items() if v.dim() > 0)
    stack = lambda key: torch.stack([m[key] for m in per_step])
    return ((torch.stack([stack(key) for key in keys]),) + tuple(stack(k) for k in hist_keys),
            keys, hist_keys)


def _as_metrics(out, clone: bool) -> Dict[str, torch.Tensor]:
    tensors, keys, hist_keys = out
    if clone:
        tensors = [t.clone() for t in tensors]
    return {**dict(zip(keys, tensors[0].unbind(0))), **dict(zip(hist_keys, tensors[1:]))}


def _stacked(name: str, value, num_steps: int, dev: torch.device,
             dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    if value is None:
        return None
    t = torch.as_tensor(value, dtype=dtype, device=dev)
    if t.shape[0] != num_steps:
        raise ValueError(f"expected {num_steps} stacked {name}, got {t.shape[0]}")
    return t


def _window_runner(step: Callable, num_steps: int, capture: Optional[bool]) -> Callable:
    """The one path from a batch source to K steps, graphed or eager.

    Returns ``run(ts, key, batch_at, bound, generators, do_dis, do_gen,
    code_batches) -> (ts, metrics)``: ``batch_at(k)`` gives step k's batch
    from tensors that keep their buffers across calls (``bound``, whose
    change drops the graphs) or from the state; ``key`` names the batch
    source's shapes; ``generators`` are drawn from by ``batch_at``. The
    state's own generator is always registered: it draws z unless
    ``code_batches`` replace them (staged into a static buffer per key),
    and the losses' and penalties' draws in any case."""
    graphs = StepGraphs()
    codes: Dict = {}

    def run(ts: TrainState, key, batch_at: Callable, bound: List[torch.Tensor],
            generators: List[torch.Generator], do_dis: bool, do_gen: bool,
            code_batches: Optional[Dict]):
        dev = ts.step.device
        zs = _stacked("code batches", None if code_batches is None else code_batches["x"],
                      num_steps, dev, torch.float32)
        if not _graphed(dev, capture):
            return ts, _as_metrics(
                _window(step, ts, num_steps, batch_at, zs, do_dis, do_gen), False)
        key = (bool(do_dis), bool(do_gen), key, None if zs is None else tuple(zs.shape))
        z_buf = None
        if zs is not None:
            if key not in codes:
                codes[key] = torch.empty_like(zs)
            z_buf = codes[key]
            z_buf.copy_(zs, non_blocking=True)
        out = graphs.run(key, ts.tensors() + bound, [ts.rng] + generators,
                         lambda: _window(step, ts, num_steps, batch_at, z_buf, do_dis, do_gen))
        return ts, _as_metrics(out, True)

    run.graphs = graphs
    return run


def _host_window(step: Callable, num_steps: int, capture: Optional[bool]) -> Callable:
    """``_window_runner`` fed K-stacked host batches, each shape staged
    into its own static buffer (the graph reads it on replay)."""
    run = _window_runner(step, num_steps, capture)
    staged: Dict = {}

    def window(ts: TrainState, batches: Dict, bound: List[torch.Tensor],
               generators: List[torch.Generator], do_dis: bool, do_gen: bool,
               code_batches: Optional[Dict]):
        xs = _stacked("batches", batches["x"], num_steps, ts.step.device)
        key = (tuple(xs.shape), xs.dtype)
        if key not in staged:
            staged[key] = torch.empty_like(xs)
        x_buf = staged[key]
        x_buf.copy_(xs, non_blocking=True)
        return run(ts, key, lambda k: {"x": x_buf[k]}, bound, generators, do_dis, do_gen,
                   code_batches)

    window.graphs = run.graphs
    return window


def graph_steps(step: Callable, num_steps: int, capture: Optional[bool] = None) -> Callable:
    """K calls of ``step`` per call, returned as ``multi_step(ts, batches,
    do_dis=True, do_gen=True, code_batches=None) -> (ts, metrics)``.

    ``batches`` is K-stacked (``{'x': [K, B, H, W, C]}``), ``code_batches``
    optionally K-stacked z (``{'x': [K, B, code]}``) that replace the
    draws; the metrics come back stacked along axis 0, cloned out of the
    graph. ``step`` has ``build_train_step``'s signature (the code batch is
    passed only when given). When the state lives on CUDA the K steps are
    one CUDA graph launch per (do_dis, do_gen) pair (``StepGraphs``): the
    host copies the batches into the graph's static buffer, then replays.
    ``capture=False`` runs the K steps eagerly, as on the CPU. The graphs
    are in ``multi_step.graphs``."""
    window = _host_window(step, num_steps, capture)

    def multi_step(ts: TrainState, batches: Dict, do_dis: bool = True, do_gen: bool = True,
                   code_batches: Optional[Dict] = None):
        return window(ts, batches, [], [], do_dis, do_gen, code_batches)

    multi_step.graphs = window.graphs
    return multi_step


def build_multi_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer, num_steps: int,
                     device: DeviceLike = None, capture: Optional[bool] = None) -> Callable:
    """K train steps per call over a K-stacked batch (``graph_steps`` of
    ``build_train_step``): one CUDA graph launch per call on CUDA, the
    counterpart of one ``lax.scan`` launch."""
    return graph_steps(build_train_step(model, opt_dis, opt_gen, device), num_steps, capture)


def imbalanced_scan(step: Callable, num_steps: int, imbalanced,
                    capture: Optional[bool] = None) -> Callable:
    """K steps per call of ``step`` with the update schedule computed on the
    device (``mmdgan_tpu/train/step.py:507-565``), graphed as
    ``graph_steps`` graphs its windows.

    ``imbalanced`` is ``[a, b]`` (D updates when step % a == 0, G when
    step % b == 0, the step read on the device) or ``'dynamic'``
    (graph_func.py:916-919: D updates while step < 1000, then when a
    uniform from ``rng`` falls below 0.1 / max(avg, 0.1); G always).
    ``avg`` is the average of loss_gen that the window carries, ``0.99 avg
    + 0.01 loss_gen`` after every step, under either schedule.

    Returns ``multi_step(ts, batches, rng, mmd_avg, code_batches=None) ->
    (ts, metrics)``: ``rng`` is a generator on the state's device (unused,
    and may be None, for a list schedule; the JAX package's key
    ``PRNGKey(start_step + 98765)`` is a generator seeded with that number
    here) and ``mmd_avg`` a 0-d float32 tensor there; both advance in
    place (JAX returns new ones) and are bound to the graphs.
    ``metrics['do_dis']`` is stacked like the other scalars. The flags
    reach ``step`` as 0-d bool tensors, so its updates are gated by
    selection (``Optimizer.gated_update_``)."""
    is_list = isinstance(imbalanced, (list, tuple))
    if not is_list and imbalanced != "dynamic":
        raise ValueError(f"imbalanced schedule {imbalanced!r} not supported")
    carried: Dict = {}

    def scheduled(ts: TrainState, batch: Dict, _do_dis, _do_gen,
                  code_batch: Optional[Dict] = None):
        avg = carried["avg"]
        if is_list:
            do_dis = torch.remainder(ts.step, imbalanced[0]) == 0
            do_gen = torch.remainder(ts.step, imbalanced[1]) == 0
        else:
            u = torch.rand((), generator=carried["rng"], device=avg.device)
            do_dis = (ts.step < 1000) | (u < 0.1 / torch.clamp(avg, min=0.1))
            do_gen = torch.ones((), dtype=torch.bool, device=avg.device)
        args = () if code_batch is None else (code_batch,)
        ts, metrics = step(ts, batch, do_dis, do_gen, *args)
        with torch.no_grad():
            avg.copy_(0.99 * avg + 0.01 * metrics["loss_gen"])
        metrics["do_dis"] = do_dis.float()
        return ts, metrics

    window = _host_window(scheduled, num_steps, capture)

    def multi_step(ts: TrainState, batches: Dict, rng: Optional[torch.Generator],
                   mmd_avg: torch.Tensor, code_batches: Optional[Dict] = None):
        if mmd_avg.device != ts.step.device:
            raise ValueError(f"mmd_avg on {mmd_avg.device}, state on {ts.step.device}")
        carried.update(rng=rng, avg=mmd_avg)
        return window(ts, batches, [mmd_avg], [] if is_list else [rng], True, True,
                      code_batches)

    multi_step.graphs = window.graphs
    return multi_step


def build_imbalanced_multi_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer,
                                num_steps: int, imbalanced, device: DeviceLike = None,
                                capture: Optional[bool] = None) -> Callable:
    """``imbalanced_scan`` of ``build_train_step``."""
    return imbalanced_scan(build_train_step(model, opt_dis, opt_gen, device), num_steps,
                           imbalanced, capture)


def build_device_data_step(
    model: SNGan,
    opt_dis: Optimizer,
    opt_gen: Optimizer,
    num_steps: int,
    batch_size: int,
    same_class: bool = False,
    sampling: str = "uniform",
    micro_batches: int = 1,
    device: DeviceLike = None,
    capture: Optional[bool] = None,
) -> Callable:
    """K train steps per call with batches taken on the device from a
    dataset already there: no host-to-device copy per step.

    Returns ``fn(ts, data_x, data_y, rng, do_dis=True, do_gen=True,
    code_batches=None) -> (ts, metrics)``; ``data_x`` is the [N, H, W, C]
    dataset (uint8 or float) on the state's device, ``data_y`` must be
    None (labels feed the conditional models, ROADMAP A13). ``rng`` is a
    generator on that device; it advances in place (JAX returns a new key).

    ``sampling``:
    - ``"uniform"``: B indices drawn with replacement from ``rng``, then a
      gather;
    - ``"shuffled_epochs"``: the contiguous rows at ``(step % n_batches) *
      B``, ``step`` read on the device, over a dataset the caller
      re-permutes at epoch boundaries (``EpochPermuter``); ``rng`` unused.

    The sampler runs inside the same CUDA graph as the steps, made as
    ``graph_steps`` makes its graphs (``_window_runner``); ``capture=False``
    runs the K steps eagerly. ``fn.sampler(data_x)`` returns it as
    ``sample(rng, step) -> batch``. ``micro_batches`` > 1 swaps the step
    for ``build_grad_accum_step`` behind the same sampler and windows
    (``mmdgan_tpu/train/step.py:723-732``). Same-class sampling (ROADMAP
    A12) and the mesh (``with_mesh``, ROADMAP A15) raise."""
    if same_class:
        raise NotImplementedError("same-class sampling is not ported yet (ROADMAP A12)")
    if sampling not in ("uniform", "shuffled_epochs"):
        raise ValueError(f"unknown sampling {sampling!r}")
    if int(micro_batches) < 1 or batch_size % int(micro_batches):
        raise ValueError(f"a batch of {batch_size} does not split into "
                         f"{micro_batches} micro-batches")
    step = (build_train_step(model, opt_dis, opt_gen, device) if int(micro_batches) == 1 else
            build_grad_accum_step(model, opt_dis, opt_gen, micro_batches, device))
    run = _window_runner(step, num_steps, capture)

    def sampler(data_x: torch.Tensor, data_y=None) -> Callable:
        if data_y is not None:
            raise NotImplementedError("labelled datasets feed the conditional models, "
                                      "which are not ported yet (ROADMAP A13)")
        n = data_x.shape[0]
        if sampling == "shuffled_epochs":
            n_batches = n // batch_size
            if n_batches < 1:
                raise ValueError(f"{n} rows hold no batch of {batch_size}")

            def sample(rng, step_count):
                off = (step_count.long() % n_batches) * batch_size
                rows = torch.arange(batch_size, device=data_x.device) + off
                return {"x": data_x.index_select(0, rows)}
        else:
            def sample(rng, step_count):
                idx = torch.randint(0, n, (batch_size,), generator=rng, device=data_x.device)
                return {"x": data_x.index_select(0, idx)}
        return sample

    def multi_step(ts: TrainState, data_x: torch.Tensor, data_y, rng: torch.Generator,
                   do_dis: bool = True, do_gen: bool = True, code_batches: Optional[Dict] = None):
        if data_x.device != ts.step.device:
            raise ValueError(f"dataset on {data_x.device}, state on {ts.step.device}")
        sample = sampler(data_x, data_y)
        return run(ts, (tuple(data_x.shape), data_x.dtype), lambda k: sample(rng, ts.step),
                   [data_x], [rng] if sampling == "uniform" else [], do_dis, do_gen, code_batches)

    def with_mesh(*args, **kwargs):
        raise NotImplementedError("the dataset sharded over a mesh is not ported yet (ROADMAP A15)")

    multi_step.sampler = sampler
    multi_step.graphs = run.graphs
    multi_step.with_mesh = with_mesh
    return multi_step


class EpochPermuter:
    """Per-epoch dataset layouts for ``sampling='shuffled_epochs'``
    (``mmdgan_tpu/train/step.py:1150-1237``).

    The layout for epoch ``e`` is ``orig[perm(e)]``, with ``perm(e)`` made
    by numpy's ``RandomState`` from the seed and the epoch alone (the same
    seed formula and permutations as the JAX package, so the layouts are
    bitwise equal to JAX's); ``perm(0)`` is the identity, kept as None. A
    resumed run jumps straight to its epoch's layout. Applied as ``delta =
    inv(perm(prev)) o perm(e)``, one ``index_select`` per epoch, written
    back in place: the tensor keeps its buffer, so a CUDA graph that reads
    it stays valid.

    :param make_perm: e -> np int array [n] for e >= 1
    :param permute: (tensors, delta) -> the same tensors, permuted in place
    """

    def __init__(self, make_perm: Callable, permute: Callable):
        self._make = make_perm
        self._permute = permute
        self.epoch = 0
        self._perm = None

    @staticmethod
    def _perm_seed(seed: int, epoch: int) -> int:
        """The JAX package's (seed, epoch) -> RandomState-seed derivation
        (its device term is 0 on one device)."""
        return (seed * 1000003 + epoch * 641) % (2**31 - 1)

    @classmethod
    def single_device(cls, n: int, seed: int) -> "EpochPermuter":
        """Permuter over an [n, ...] dataset on one device."""

        def make_perm(e):
            return np.random.RandomState(cls._perm_seed(seed, e)).permutation(n)

        def permute(arrs, delta):
            for a in arrs:
                if a is not None:
                    a.copy_(a.index_select(0, torch.as_tensor(delta, device=a.device)))
            return arrs

        return cls(make_perm, permute)

    def advance(self, e_now: int, arrs):
        """Bring ``arrs`` to epoch ``e_now``'s layout (no-op if there)."""
        if e_now == self.epoch:
            return arrs
        prev = self._perm
        cur = None if e_now == 0 else self._make(e_now)
        self.epoch, self._perm = e_now, cur
        if prev is None:
            delta = cur
        else:
            inv = np.argsort(prev)
            delta = inv if cur is None else inv[cur]
        return arrs if delta is None else self._permute(arrs, delta)


def build_eval_step(model: SNGan) -> Callable:
    """Eval-mode generation (``mmdgan_tpu/train/step.py:1240-1246``):
    ``eval_step(ts, generator, batch_size) -> [N, H, W, C]`` images in
    [-1, 1], z drawn from ``generator``."""

    def eval_step(ts: TrainState, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        return model.generate(ts.params, ts.net_state, generator, batch_size)

    return eval_step
