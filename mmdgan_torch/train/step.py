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
  device from a dataset that lives there, the sampler inside the graph,
  labelled and same-class too; it shares ``graph_steps``' window runner
  (``_window_runner``).
- ``same_class_tables`` / ``sharded_same_class_tables`` /
  ``class_schedule``: the host tables of same-class sampling, numpy copies
  of the JAX package's.
- ``EpochPermuter``: the per-epoch layouts of ``sampling='shuffled_epochs'``,
  one device's or one rank's shard's.
- ``build_eval_step``: eval-mode generation.

Data parallelism: the step builders take ``dp`` (a
``parallel.DataParallel``) and then build the step of one rank of the
mesh, with the global-batch semantics of one device at the global batch
(``parallel/collectives.py``): each rank feeds its rows of the global
batch, the step draws at the global batch and takes its rows, gathers the
scores, and averages each network's gradients over the ranks through one
flat buffer, every step, whatever ``do_dis``/``do_gen`` are (so a captured
window issues a fixed sequence of collectives). Without ``dp`` no
collective runs. The device-data step shards the dataset
(``with_mesh``).

A state sharded over the mesh (``DataParallel.shard_state``: fsdp, or a
2-D mesh's model axis) runs the gather-at-entry schedule in every step
(``parallel.mesh.StateLayout``): the weights all-gathered into full-size
buffers made once, the step computed as above, each network's gradient
reduce-scattered, and each rank's optimizer updating its own shards of
the parameters and slots. The collectives are the same every step, so a
window over an NCCL mesh captures them as it captures the others.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

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
from mmdgan_torch.parallel.collectives import (
    all_gather,
    all_gather_raw,
    average_flat,
    batch_mean,
    from_rank0,
    gathered_mean,
)
from mmdgan_torch.train.optim import Optimizer
from mmdgan_torch.train.state import TrainState, loss_state_leaves, tree_leaves


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


def _entry_params(ts: TrainState, dp) -> Dict:
    """The whole parameters the step computes with: the state's own, or,
    for a sharded state, the weights all-gathered at step entry."""
    layout = ts.layout
    if layout is None:
        return ts.params
    if layout.dp is not dp:
        raise ValueError("the state is sharded on another mesh than the step was built with")
    return layout.gather(ts)


def _mean_grads(ts: TrainState, net: str, grads: List[torch.Tensor], dp) -> List[torch.Tensor]:
    """A network's gradients as its state leaves take them: as computed
    without a mesh; averaged over the ranks with one; a sharded state's
    split leaves get the rank's shard of the average."""
    if ts.layout is not None:
        return ts.layout.reduce_grads(net, grads)
    return grads if dp is None else average_flat(grads, dp)


def _grad_norm(ts: TrainState, net: str, grads: List[torch.Tensor]) -> torch.Tensor:
    if ts.layout is not None:
        return ts.layout.global_norm(net, grads)
    return _global_norm(grads)


def _update(opt: Optimizer, do, leaves, grads, opt_state) -> None:
    """One optimizer update gated by ``do``: a Python bool by ``if``, a 0-d
    bool tensor (a flag on the device) by ``Optimizer.gated_update_``."""
    if isinstance(do, torch.Tensor):
        opt.gated_update_(leaves, grads, opt_state, do)
    elif do:
        opt.update_(leaves, grads, opt_state)


def _set_net_state(ts: TrainState, new, dp) -> None:
    """Write the step's new SN vectors and BN statistics (a tree or its
    leaves) into the state in place; under a mesh, rank 0's (the BN
    statistics are global already; the SN vectors are each rank's own
    power iteration, which a nondeterministic kernel may round
    differently)."""
    leaves = tree_leaves(new) if isinstance(new, dict) else list(new)
    if dp is not None:
        leaves = from_rank0(leaves, dp)
    with torch.no_grad():
        torch._foreach_copy_(tree_leaves(ts.net_state), leaves)


def _check_mesh(dp, dev: torch.device) -> None:
    if dp is not None and dp.device != dev:
        raise ValueError(f"the mesh's rank runs on {dp.device}, the model on {dev}")


def build_train_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer,
                     device: DeviceLike = None, dp=None) -> Callable:
    """Returns ``train_step(ts, data_batch, do_dis=True, do_gen=True,
    code_batch=None, uni=None) -> (ts, metrics)``. ``data_batch['x']`` is
    NHWC ([B, H, W, C], float in [-1, 1] or uint8); ``code_batch={'x': z}``
    replaces the z draw, as ``gen_stage(code_batch=...)`` does in JAX, and
    ``uni`` ([B, 1, 1, 1]) the penalty's interpolation weights. The step
    draws from the state's one generator in a fixed order: z, then the
    loss's draws, then the penalty's interpolation weights (JAX splits its
    key into ``rng_code``, ``rng_loss`` and ``rng_gp``).

    With a mesh (``dp``) ``data_batch`` holds the rank's rows and
    ``code_batch`` and ``uni`` the global batch's; the gradients are
    averaged over the ranks. ``train_step.dp`` is the mesh."""
    dev = check_device(model.device, device)
    _check_mesh(dp, dev)

    def train_step(ts: TrainState, data_batch: Dict, do_dis: bool = True,
                   do_gen: bool = True, code_batch: Optional[Dict] = None, uni=None):
        x = torch.as_tensor(data_batch["x"], device=dev)
        x = to_nchw(decode_image_batch({"x": x})["x"])
        y = model.as_labels(data_batch.get("y"), x.shape[0])
        params = _entry_params(ts, dp)
        gen_x, gen_state, codes = model.gen_stage(
            params["gen"], ts.net_state, x.shape[0], ts.rng, code_batch, data_y=y, dp=dp)
        loss_gen, loss_dis, dis_state, new_loss_state, aux = model.dis_stage(
            params["dis"], gen_x, ts.net_state, ts.loss_state, x, generator=ts.rng,
            y_real=y, code_y=codes["y"], uni=uni, dp=dp)
        grads_dis = _grads(loss_dis, tree_leaves(params["dis"]), retain_graph=True)
        grads_gen = _grads(loss_gen, tree_leaves(params["gen"]))
        grads_dis = _mean_grads(ts, "dis", grads_dis, dp)
        grads_gen = _mean_grads(ts, "gen", grads_gen, dp)
        _update(opt_dis, do_dis, tree_leaves(ts.params["dis"]), grads_dis, ts.opt_state_dis)
        _update(opt_gen, do_gen, tree_leaves(ts.params["gen"]), grads_gen, ts.opt_state_gen)
        # after both gradients: autograd saved the old SN vectors
        _set_net_state(ts, {"gen": gen_state, "dis": dis_state}, dp)
        with torch.no_grad():
            torch._foreach_copy_(loss_state_leaves(ts.loss_state),
                                 loss_state_leaves(new_loss_state))
            ts.step.add_(1)
        metrics = {"loss_gen": loss_gen.detach(), "loss_dis": loss_dis.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        if model.do_summary:
            metrics["grad_norm_dis"] = _grad_norm(ts, "dis", grads_dis)
            metrics["grad_norm_gen"] = _grad_norm(ts, "gen", grads_gen)
        return ts, metrics

    train_step.dp = dp
    return train_step


def build_grad_accum_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer,
                          micro_batches: int, device: DeviceLike = None, dp=None) -> Callable:
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
    state's generator in the fused step's order: all B rows of z (and of
    a conditional model's code labels), then the loss's draws, then all B
    rows of ``uni``, split per micro-batch beside x, the labels y and z
    (``mmdgan_tpu/train/step.py:242-257``);
    so at M=1, or on a model without BN, it equals the fused step up to
    summation order.

    With BN, train mode normalises each micro-batch by its own
    statistics, and the step's moving-statistic update is the average of
    the micro-batches' updates (every state leaf is averaged; the SN
    vectors are the same in every micro-batch).

    With a mesh (``dp``), micro-batch m is still global rows [mB/M,
    (m+1)B/M) as in JAX (``mmdgan_tpu/train/step.py:221-223``), so rank r
    holds the r-th B/(MN) rows of every micro-batch: its ``data_batch`` is
    that micro-major shard (``DataParallel.local_rows(x, M)``), and z and
    ``uni``, drawn or given at the global batch, are sliced so. Pass 1
    gathers each micro-batch's scores; pass 2 pulls the global cotangents
    through the same gather; the penalty's score cotangents and the
    gradients are averaged over the ranks."""
    dev = check_device(model.device, device)
    _check_mesh(dp, dev)
    ranks = 1 if dp is None else dp.size
    m_count = int(micro_batches)
    if m_count < 1:
        raise ValueError(f"micro_batches must be >= 1, got {micro_batches}")
    loss_type = model.loss_type
    is_gp, is_w, is_ds = (loss_type in GP_LOSSES, loss_type == "wasserstein",
                          loss_type in DS_LOSSES)
    needs_gx = is_gp or is_w

    def micro_fwd(ts: TrainState, params: Dict, mb: Dict):
        """Scores of concat(real, fake), real first; the new states; the
        generated images."""
        gen_x, gen_state = model.Gen.apply(params["gen"], ts.net_state["gen"], mb["z"],
                                           train=True, label=mb["zy"], dp=dp)
        dis_in = model.concat_two_batches({"x": mb["x"], "y": mb["y"]},
                                          {"x": gen_x, "y": mb["zy"]})
        scores, dis_state = model.Dis.apply(params["dis"], ts.net_state["dis"], dis_in["x"],
                                            train=True, label=dis_in["y"], dp=dp)
        return scores, {"gen": gen_state, "dis": dis_state}, gen_x

    def global_rows(scores: torch.Tensor, gather: Callable) -> torch.Tensor:
        """A micro-batch's scores of concat(real, fake) on every rank as
        the global micro-batch's: real rows of ranks 0..N-1, then the
        generated ones."""
        if dp is None:
            return scores
        n = scores.shape[0] // 2
        both = gather(scores, dp).view(ranks, 2, n, scores.shape[1])
        return both.transpose(0, 1).reshape(2 * ranks * n, scores.shape[1])

    def train_step(ts: TrainState, data_batch: Dict, do_dis: bool = True, do_gen: bool = True,
                   code_batch: Optional[Dict] = None, uni: Optional[torch.Tensor] = None):
        x = torch.as_tensor(data_batch["x"], device=dev)
        x = to_nchw(decode_image_batch({"x": x})["x"])
        b = x.shape[0] * ranks
        if x.shape[0] % m_count:
            raise ValueError(f"a batch of {x.shape[0]} does not split into {m_count} "
                             "micro-batches")
        y = model.as_labels(data_batch.get("y"), x.shape[0])
        codes = model.step_codes(ts.rng, x.shape[0], code_batch, y, dp, m_count)
        split = lambda t: [None] * m_count if t is None else t.chunk(m_count)   # noqa: E731
        mbs = [dict(zip(("x", "y", "z", "zy"), parts)) for parts in
               zip(x.chunk(m_count), split(y), codes["x"].chunk(m_count), split(codes["y"]))]
        xs, ys = x.chunk(m_count), split(y)
        params = _entry_params(ts, dp)
        dis_leaves = tree_leaves(params["dis"])
        gen_leaves = tree_leaves(params["gen"])

        # pass 1: scores only (and the images the penalties interpolate)
        n = b // m_count
        s_xs, s_gens, gxs, gx_abs = [], [], [], []
        with torch.no_grad():
            for mb in mbs:
                scores, _, gen_x = micro_fwd(ts, params, mb)
                scores = global_rows(scores, all_gather_raw)
                s_xs.append(scores[:n])
                s_gens.append(scores[n:])
                if needs_gx:
                    gxs.append(gen_x)
                else:
                    gx_abs.append(gathered_mean(torch.abs(gen_x), dp))
        # the global scores, leaves of the penalty's and the loss's pulls
        s_x, s_gen = torch.cat(s_xs).requires_grad_(True), torch.cat(s_gens).requires_grad_(True)
        gx_abs_mean = (gathered_mean(torch.abs(torch.cat(gxs)), dp) if needs_gx else
                       torch.mean(torch.stack(gx_abs)))
        draws = model.loss_hp.draw(loss_type, s_gen, ts.rng)

        # the penalty or scale pass, per micro-batch
        pen_in = scale_in = None
        if needs_gx:
            if uni is None:
                uni = torch.rand((b, 1, 1, 1), generator=ts.rng, device=dev)
            uni = torch.as_tensor(uni, dtype=torch.float32, device=dev)
            unis = (uni if dp is None else dp.local_rows(uni, m_count)).chunk(m_count)
            wrt = dis_leaves + ([s_x, s_gen] if is_gp else [])
            pen_sum, pen_gd = 0.0, [torch.zeros_like(t) for t in wrt]
            for xm, ym, gxm, um in zip(xs, ys, gxs, unis):
                if is_gp:
                    pen = model.mmd_gradient_penalty(params["dis"], ts.net_state, xm, gxm,
                                                     s_x, s_gen, mode=loss_type, uni=um,
                                                     labels=ym, dp=dp)
                else:
                    pen = model.gradient_penalty(params["dis"], ts.net_state, xm, gxm, uni=um,
                                                 labels=ym, dp=dp)
                torch._foreach_add_(pen_gd, _grads(pen, wrt))
                pen_sum = pen_sum + pen.detach()
            if is_gp and dp is not None:
                # every rank holds the scores: their cotangents are averaged
                pen_gd[-2:] = average_flat(pen_gd[-2:], dp)
            # the mean over B rows is the mean of the M equal micro means
            pen_in = (model.gp_weight * pen_sum / m_count).requires_grad_(True)
        elif is_ds:
            jaco_sum, pen_gd = 0.0, [torch.zeros_like(t) for t in dis_leaves]
            for xm, ym in zip(xs, ys):
                def fwd(xx, ym=ym):
                    return model._dis_fwd(params["dis"], ts.net_state, xx, ym)
                jaco = batch_mean(jacobian_squared_frobenius_norm(fwd, xm), dp)
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
        for mb, ct_d, ct_g in zip(mbs, cts_d, cts_g):
            scores, new_state, _ = micro_fwd(ts, params, mb)
            scores = global_rows(scores, all_gather)
            torch._foreach_add_(grads_dis, _grads(scores, dis_leaves, True, ct_d))
            torch._foreach_add_(grads_gen, _grads(scores, gen_leaves, False, ct_g))
            torch._foreach_add_(state_sum, tree_leaves(new_state))
        if needs_gx:
            torch._foreach_add_(grads_dis, torch._foreach_mul(pen_gd[:len(dis_leaves)], w_pen))
        elif is_ds:
            # scale = 1 / (w mean + 1), so d scale / d mean = -w scale^2
            w_ds = cd_extra[0] * (-model.penalty_weight * dis_scale.detach() ** 2) / m_count
            torch._foreach_add_(grads_dis, torch._foreach_mul(pen_gd, w_ds))
        grads_dis = _mean_grads(ts, "dis", grads_dis, dp)
        grads_gen = _mean_grads(ts, "gen", grads_gen, dp)

        _update(opt_dis, do_dis, tree_leaves(ts.params["dis"]), grads_dis, ts.opt_state_dis)
        _update(opt_gen, do_gen, tree_leaves(ts.params["gen"]), grads_gen, ts.opt_state_gen)
        with torch.no_grad():
            _set_net_state(ts, torch._foreach_div(state_sum, m_count), dp)
            torch._foreach_copy_(loss_state_leaves(ts.loss_state),
                                 loss_state_leaves(new_loss_state))
            ts.step.add_(1)
        metrics = {"loss_gen": loss_gen.detach(), "loss_dis": loss_dis.detach(),
                   "s_x_mean": torch.mean(s_x.detach()), "s_gen_mean": torch.mean(s_gen.detach()),
                   "x_gen_abs_mean": gx_abs_mean, **{k: v.detach() for k, v in loss_aux.items()}}
        if model.do_summary:
            metrics["grad_norm_dis"] = _grad_norm(ts, "dis", grads_dis)
            metrics["grad_norm_gen"] = _grad_norm(ts, "gen", grads_gen)
        return ts, metrics

    train_step.dp = dp
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


def _graphed(dev: torch.device, capture: Optional[bool], dp=None) -> bool:
    """Whether a window is captured: on CUDA unless ``capture=False``. A
    gloo mesh runs eager windows, by rule: its collectives move through
    host memory, which a CUDA graph cannot capture (an NCCL mesh's are
    captured, and a capture that fails raises)."""
    if dp is not None and dp.backend == "gloo":
        if capture:
            raise ValueError("a gloo mesh runs eager windows: its collectives cannot be captured")
        return False
    if capture is None:
        return dev.type == "cuda"
    if capture and dev.type != "cuda":
        raise ValueError(f"capture=True needs a state on CUDA, not {dev}")
    return bool(capture)


def _window(step: Callable, ts: TrainState, num_steps: int, batch_at: Callable,
            codes: Optional[Dict], do_dis: bool, do_gen: bool):
    """K steps; returns the [n_scalars, K] stacked scalar metrics, then one
    [K, nbins] stack per ``hist/*`` metric, then the keys of both.
    ``codes``: K-stacked z (and code labels) replacing the draws."""
    per_step = []
    for k in range(num_steps):
        if codes is None:
            ts, m = step(ts, batch_at(k), do_dis, do_gen)
        else:
            ts, m = step(ts, batch_at(k), do_dis, do_gen,
                         {key: None if v is None else v[k] for key, v in codes.items()})
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


class _Staging:
    """Static device buffers, one per (name, shape, dtype): a graph reads
    the buffer it was captured on, so each call copies its values in."""

    def __init__(self):
        self._bufs: Dict = {}

    def __call__(self, name: str, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None:
            return None
        key = (name, tuple(t.shape), t.dtype)
        if key not in self._bufs:
            self._bufs[key] = torch.empty_like(t)
        buf = self._bufs[key]
        buf.copy_(t, non_blocking=True)
        return buf


def _signature(*tensors) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in tensors)


def _window_runner(step: Callable, num_steps: int, capture: Optional[bool]) -> Callable:
    """The one path from a batch source to K steps, graphed or eager.

    Returns ``run(ts, key, batch_at, bound, generators, do_dis, do_gen,
    code_batches) -> (ts, metrics)``: ``batch_at(k)`` gives step k's batch
    from tensors that keep their buffers across calls (``bound``, whose
    change drops the graphs) or from the state; ``key`` names the batch
    source's shapes; ``generators`` are drawn from by ``batch_at``. The
    state's own generator is always registered: it draws z (and a
    conditional model's code labels) unless ``code_batches`` replace them
    (staged into static buffers), and the losses' and penalties' draws in
    any case."""
    graphs = StepGraphs()
    stage = _Staging()
    dp = getattr(step, "dp", None)

    def run(ts: TrainState, key, batch_at: Callable, bound: List[torch.Tensor],
            generators: List[torch.Generator], do_dis: bool, do_gen: bool,
            code_batches: Optional[Dict]):
        dev = ts.step.device
        codes = None
        if code_batches is not None:
            codes = {"x": _stacked("code batches", code_batches["x"], num_steps, dev,
                                   torch.float32),
                     "y": _stacked("code labels", code_batches.get("y"), num_steps, dev,
                                   torch.int64)}
        if not _graphed(dev, capture, dp):
            return ts, _as_metrics(
                _window(step, ts, num_steps, batch_at, codes, do_dis, do_gen), False)
        key = (bool(do_dis), bool(do_gen), key,
               None if codes is None else _signature(codes["x"], codes["y"]))
        if codes is not None:
            codes = {name: stage(name, v) for name, v in codes.items()}
        out = graphs.run(key, ts.tensors() + bound, [ts.rng] + generators,
                         lambda: _window(step, ts, num_steps, batch_at, codes, do_dis, do_gen))
        return ts, _as_metrics(out, True)

    run.graphs = graphs
    run.dp = dp
    return run


def _host_window(step: Callable, num_steps: int, capture: Optional[bool]) -> Callable:
    """``_window_runner`` fed K-stacked host batches (x, and labels y when
    given), each shape staged into its own static buffer (the graph reads
    it on replay)."""
    run = _window_runner(step, num_steps, capture)
    stage = _Staging()

    def window(ts: TrainState, batches: Dict, bound: List[torch.Tensor],
               generators: List[torch.Generator], do_dis: bool, do_gen: bool,
               code_batches: Optional[Dict]):
        dev = ts.step.device
        xs = _stacked("batches", batches["x"], num_steps, dev)
        ys = _stacked("labels", batches.get("y"), num_steps, dev, torch.int64)
        key = _signature(xs, ys)
        x_buf, y_buf = stage("x", xs), stage("y", ys)
        return run(ts, key, lambda k: {"x": x_buf[k], "y": None if y_buf is None else y_buf[k]},
                   bound, generators, do_dis, do_gen, code_batches)

    window.graphs = run.graphs
    window.dp = run.dp
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
    multi_step.dp = window.dp
    return multi_step


def build_multi_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer, num_steps: int,
                     device: DeviceLike = None, capture: Optional[bool] = None,
                     dp=None) -> Callable:
    """K train steps per call over a K-stacked batch (``graph_steps`` of
    ``build_train_step``): one CUDA graph launch per call on CUDA, the
    counterpart of one ``lax.scan`` launch."""
    return graph_steps(build_train_step(model, opt_dis, opt_gen, device, dp), num_steps, capture)


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
    scheduled, carried = _scheduled_step(step, imbalanced)
    window = _host_window(scheduled, num_steps, capture)

    def multi_step(ts: TrainState, batches: Dict, rng: Optional[torch.Generator],
                   mmd_avg: torch.Tensor, code_batches: Optional[Dict] = None):
        carried.set(ts, rng, mmd_avg)
        return window(ts, batches, [mmd_avg], carried.generators, True, True, code_batches)

    multi_step.graphs = window.graphs
    multi_step.dp = window.dp
    return multi_step


class _Carried:
    """What an imbalanced window carries across calls: the generator of a
    'dynamic' schedule and the loss average, bound to the graphs."""

    def __init__(self, is_list: bool):
        self.is_list = is_list
        self.rng = self.avg = None
        self.generators: List[torch.Generator] = []

    def set(self, ts: TrainState, rng: Optional[torch.Generator], avg: torch.Tensor) -> None:
        if avg.device != ts.step.device:
            raise ValueError(f"mmd_avg on {avg.device}, state on {ts.step.device}")
        self.rng, self.avg = rng, avg
        self.generators = [] if self.is_list else [rng]


def _scheduled_step(step: Callable, imbalanced) -> Tuple[Callable, _Carried]:
    """``step`` with its update flags computed on the device from the step
    count (``[a, b]``) or from a uniform of the carried generator and the
    carried loss average (``'dynamic'``); the average advances after every
    step. Every rank of a mesh decides alike: the count, the generator and
    the average (of the global loss) are replicated."""
    is_list = isinstance(imbalanced, (list, tuple))
    if not is_list and imbalanced != "dynamic":
        raise ValueError(f"imbalanced schedule {imbalanced!r} not supported")
    carried = _Carried(is_list)

    def scheduled(ts: TrainState, batch: Dict, _do_dis, _do_gen,
                  code_batch: Optional[Dict] = None):
        avg = carried.avg
        if is_list:
            do_dis = torch.remainder(ts.step, imbalanced[0]) == 0
            do_gen = torch.remainder(ts.step, imbalanced[1]) == 0
        else:
            u = torch.rand((), generator=carried.rng, device=avg.device)
            do_dis = (ts.step < 1000) | (u < 0.1 / torch.clamp(avg, min=0.1))
            do_gen = torch.ones((), dtype=torch.bool, device=avg.device)
        args = () if code_batch is None else (code_batch,)
        ts, metrics = step(ts, batch, do_dis, do_gen, *args)
        with torch.no_grad():
            avg.copy_(0.99 * avg + 0.01 * metrics["loss_gen"])
        metrics["do_dis"] = do_dis.float()
        return ts, metrics

    scheduled.dp = getattr(step, "dp", None)
    return scheduled, carried


def build_imbalanced_multi_step(model: SNGan, opt_dis: Optimizer, opt_gen: Optimizer,
                                num_steps: int, imbalanced, device: DeviceLike = None,
                                capture: Optional[bool] = None, dp=None) -> Callable:
    """``imbalanced_scan`` of ``build_train_step``."""
    return imbalanced_scan(build_train_step(model, opt_dis, opt_gen, device, dp), num_steps,
                           imbalanced, capture)


def same_class_tables(y, num_class: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host per-class row tables for same-class sampling (the reference's
    group_by_window batching, input_func.py:905-916; a copy of
    ``mmdgan_tpu/train/step.py:567-586``, bitwise equal).

    Returns (table [num_class, max_count] int32, counts [num_class] int32):
    ``table[c, :counts[c]]`` are the rows of class c, repeated to pad."""
    y = np.asarray(y).reshape(-1)
    counts = np.asarray([(y == c).sum() for c in range(num_class)], np.int32)
    assert counts.min() > 0, "every class needs at least one example"
    width = int(counts.max())
    table = np.zeros((num_class, width), np.int32)
    for c in range(num_class):
        table[c] = np.resize(np.nonzero(y == c)[0].astype(np.int32), width)
    return table, counts


def sharded_same_class_tables(y, num_class: int, num_shards: int,
                              width: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-rank class tables over a dataset sharded in contiguous row
    blocks (shard d holds rows ``[d*N/D, (d+1)*N/D)``), each indexing the
    LOCAL rows of its block (a copy of
    ``mmdgan_tpu/train/step.py:588-630``, bitwise equal).

    Returns (tables [num_shards, num_class, width] int32, counts
    [num_shards, num_class] int32); rank d takes ``tables[d]``. Every class
    must be present on every shard (shuffle a class-sorted source first).
    ``width`` > 0 pins the width instead of the largest local count."""
    y = np.asarray(y).reshape(-1)
    n = y.shape[0]
    assert n % num_shards == 0, f"dataset rows {n} must divide over {num_shards} devices"
    local_n = n // num_shards
    per_shard = [same_class_tables(y[d * local_n:(d + 1) * local_n], num_class)
                 for d in range(num_shards)]
    max_count = max(t.shape[1] for t, _ in per_shard)
    if width:
        assert width >= max_count, (width, max_count)
    else:
        width = max_count
    tables = np.zeros((num_shards, num_class, width), np.int32)
    counts = np.zeros((num_shards, num_class), np.int32)
    for d, (t, c) in enumerate(per_shard):
        tables[d] = np.stack([np.resize(t[k, :c[k]], width) for k in range(num_class)])
        counts[d] = c
    return tables, counts


def class_schedule(num_class: int, n_steps: int, seed: int) -> np.ndarray:
    """Host class schedule of same-class ``shuffled_epochs`` sampling (a
    copy of ``mmdgan_tpu/train/step.py:632-655``, bitwise equal): [n_steps,
    2] int32 rows ``(c_t, k_t)``, the class of step t and how many earlier
    steps drew it. A pure function of (seed, num_class), so a resumed run
    regenerates it from the checkpointed step."""
    draws = np.random.RandomState((seed * 1000003 + 777) % (2**31 - 1)).randint(
        0, num_class, size=n_steps).astype(np.int32)
    k = np.zeros(n_steps, np.int32)
    for c in range(num_class):
        pos = np.nonzero(draws == c)[0]
        k[pos] = np.arange(pos.size, dtype=np.int32)
    return np.stack([draws, k], axis=1)


def _int64(v: int) -> int:
    """A 64-bit constant as the signed value a torch int64 holds."""
    return v - (1 << 64) if v >= 1 << 63 else v


_GOLDEN, _MIX1, _MIX2 = (_int64(0x9E3779B97F4A7C15), _int64(0xBF58476D1CE4E5B9),
                         _int64(0x94D049BB133111EB))


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's ``>>`` keeps the sign)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 tensors (wrapping arithmetic)."""
    x = x + _GOLDEN
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def class_epoch_slots(seed: int, c: torch.Tensor, e: torch.Tensor, count: torch.Tensor,
                      width: int, rank: int = 0) -> torch.Tensor:
    """A uniform permutation of class ``c``'s ``count`` valid slots for its
    class-epoch ``e``: the argsort of counter-based hashes of (seed, c, e,
    slot), the padded slots pushed past the valid ones. A pure function of
    its arguments, computed on the device (the counterpart of JAX's
    ``fold_in(fold_in(key, c), e)`` uniforms, ``step.py:763-801``; the
    numbers differ). A mesh rank > 0 folds its index in after the seed,
    as JAX folds the device index (``:1009-1010``); rank 0 keeps the
    single-device stream."""
    slot = torch.arange(width, device=c.device, dtype=torch.int64)
    h = splitmix64(torch.full_like(c, seed, dtype=torch.int64))
    if rank:
        h = splitmix64(h ^ rank)
    h = splitmix64(splitmix64(h ^ c.long()) ^ e.long())
    keys = splitmix64(h ^ slot) & ((1 << 63) - 1)
    keys = torch.where(slot < count, keys, torch.full_like(keys, (1 << 63) - 1))
    return torch.argsort(keys, stable=True)


def build_device_data_step(
    model: SNGan,
    opt_dis: Optimizer,
    opt_gen: Optimizer,
    num_steps: int,
    batch_size: int,
    same_class: bool = False,
    class_table=None,
    class_counts=None,
    sampling: str = "uniform",
    sampler_seed: int = 0,
    micro_batches: int = 1,
    device: DeviceLike = None,
    capture: Optional[bool] = None,
) -> Callable:
    """K train steps per call with batches taken on the device from a
    dataset already there: no host-to-device copy per step.

    Returns ``fn(ts, data_x, data_y, rng, do_dis=True, do_gen=True,
    code_batches=None, schedule=None) -> (ts, metrics)``; ``data_x`` is the
    [N, H, W, C] dataset (uint8 or float) on the state's device, ``data_y``
    its [N, 1] int labels there or None. ``rng`` is a generator on that
    device; it advances in place (JAX returns a new key).

    ``sampling``:
    - ``"uniform"``: B indices drawn with replacement from ``rng``, then a
      gather;
    - ``"shuffled_epochs"``: the contiguous rows at ``(step % n_batches) *
      B``, ``step`` read on the device, over a dataset the caller
      re-permutes at epoch boundaries (``EpochPermuter``); ``rng`` unused.

    ``same_class`` takes every batch from one class (group_by_window,
    ``mmdgan_tpu/train/step.py:817-833``), with ``class_table`` and
    ``class_counts`` from ``same_class_tables``; its labels are the class
    (``data_y`` may be None):
    - under ``uniform``, the class and the B slots come from ``rng``
      (``floor(u * count)``, the count read on the device);
    - under ``shuffled_epochs``, ``schedule`` ([K, 2] rows of
      ``class_schedule``, on the device) names each step's class and its
      draw count k; each class walks its own without-replacement epochs,
      slice ``k % (count // B)`` of the permutation of class-epoch
      ``k // (count // B)`` (``class_epoch_slots`` from ``sampler_seed``):
      nothing is carried, so a resume replays the streams. Every class
      needs at least B rows.

    The sampler runs inside the same CUDA graph as the steps, made as
    ``graph_steps`` makes its graphs (``_window_runner``); ``capture=False``
    runs the K steps eagerly. ``fn.sampler(data_x, data_y)`` returns it as
    ``sample(rng, step, sched=None) -> batch``. ``micro_batches`` > 1 swaps
    the step for ``build_grad_accum_step`` behind the same sampler and
    windows (``mmdgan_tpu/train/step.py:723-732``).

    ``fn.with_mesh(dp, axis=None, imbalanced=None)`` returns the same
    window over a mesh and/or under an update schedule
    (``mmdgan_tpu/train/step.py:1031-1146``):
    - with ``dp`` each rank holds its shard of the dataset (``data_x`` /
      ``data_y`` are the rank's rows) and takes its B/N rows of every
      batch from it, so the dataset costs N/D rows per card and sampling
      needs no collective. The uniform samplers draw the global batch's
      numbers from the replicated ``rng`` and each rank takes its block
      of them (its indices into its own rows: a stream per (seed, rank));
      same-class draws one global class per step and the rank's slots of
      it from its own class table (``class_table`` [C, width] over its
      rows, or ``sharded_same_class_tables``' [N, C, width], of which the
      rank takes its own); the scheduled sampler walks each class's local
      epochs with the rank folded into the permutation's hash; shuffled
      epochs slice the rank's rows, which the caller re-permutes
      (``EpochPermuter.sharded``);
    - ``imbalanced`` ([a, b] or 'dynamic', as ``imbalanced_scan``)
      computes the update flags on the device; the window is then
      ``fn(ts, data_x, data_y, rng, mmd_avg, code_batches=None)``, the
      'dynamic' uniform drawn from ``rng`` after each step's batch. Not
      with same-class shuffled epochs (its schedule is step-indexed)."""
    if sampling not in ("uniform", "shuffled_epochs"):
        raise ValueError(f"unknown sampling {sampling!r}")
    if int(micro_batches) < 1 or batch_size % int(micro_batches):
        raise ValueError(f"a batch of {batch_size} does not split into "
                         f"{micro_batches} micro-batches")
    scheduled = same_class and sampling == "shuffled_epochs"
    if same_class:
        if class_table is None or class_counts is None:
            raise ValueError("same_class sampling needs same_class_tables(y, num_class)")
        class_table = np.asarray(class_table)
        class_counts = np.asarray(class_counts)

    def make(dp=None, axis: Optional[str] = None, imbalanced=None) -> Callable:
        if dp is not None and axis is not None and axis != dp.axis:
            raise ValueError(f"the mesh's axis is {dp.axis!r}, not {axis!r}")
        if getattr(dp, "model_axis", None) is not None:
            raise ValueError("HBM-resident datasets are data-parallel only (the shard_map "
                             "sampler shards rows over the data axis); use a 1-D mesh")
        if scheduled and imbalanced is not None:
            raise ValueError("same_class + shuffled_epochs is not combinable with imbalanced "
                             "schedules (the class schedule is step-indexed)")
        ranks, rank = (1, 0) if dp is None else (dp.size, dp.rank)
        if batch_size % (ranks * int(micro_batches)):
            raise ValueError(f"a batch of {batch_size} does not split over {ranks} ranks x "
                             f"{micro_batches} micro-batches")
        b = batch_size // ranks
        table = counts = None
        if same_class:
            table, counts = class_table, class_counts
            if table.ndim == 3:
                if table.shape[0] != ranks:
                    raise ValueError(f"sharded class tables for {table.shape[0]} ranks, the "
                                     f"mesh has {ranks}")
                table, counts = table[rank], counts[rank]
            if scheduled and int(counts.min()) < b:
                raise ValueError(f"same_class + shuffled_epochs needs every class to hold >= "
                                 f"batch_size rows (batch_size / ranks on a mesh's shard); "
                                 f"min count {int(counts.min())} < {b}")
        step = (build_train_step(model, opt_dis, opt_gen, device, dp) if int(micro_batches) == 1
                else build_grad_accum_step(model, opt_dis, opt_gen, micro_batches, device, dp))
        carried = None
        if imbalanced is not None:
            step, carried = _scheduled_step(step, imbalanced)
        run = _window_runner(step, num_steps, capture)
        stage = _Staging()
        tables: Dict = {}   # device copies of the class tables, made once per device

        def _tables(dev):
            if dev not in tables:
                tables[dev] = (torch.as_tensor(table, dtype=torch.int64, device=dev),
                               torch.as_tensor(counts, dtype=torch.int64, device=dev))
            return tables[dev]

        def block(t: torch.Tensor) -> torch.Tensor:
            """This rank's numbers of a draw made for the global batch."""
            return t if dp is None else t.narrow(0, rank * b, b)

        def sampler(data_x: torch.Tensor, data_y: Optional[torch.Tensor] = None) -> Callable:
            n, dev = data_x.shape[0], data_x.device

            def take(idx, c=None):
                y = (data_y.index_select(0, idx) if data_y is not None else
                     None if c is None else c.expand(b, 1).clone())
                return {"x": data_x.index_select(0, idx), "y": y}

            if same_class:
                tbl, cnt = _tables(dev)
                # a class's row table and count, gathered on the device
                row_of = lambda c: (tbl.index_select(0, c.view(1))[0],   # noqa: E731
                                    cnt.index_select(0, c.view(1))[0])
                if scheduled:
                    def sample(rng, step_count, sched):
                        c, k = sched[0].long(), sched[1].long()
                        rows_c, count = row_of(c)
                        dpe = torch.clamp(count // b, min=1)
                        slots = class_epoch_slots(sampler_seed, c, k // dpe, count,
                                                  tbl.shape[1], rank)
                        rows = torch.arange(b, device=dev) + (k % dpe) * b
                        return take(rows_c.index_select(0, slots.index_select(0, rows)), c)
                else:
                    def sample(rng, step_count, sched=None):
                        # one class per batch, B slots of it (group_by_window)
                        u = torch.rand(batch_size + 1, generator=rng, device=dev,
                                       dtype=torch.float64)
                        c = torch.clamp((u[0] * tbl.shape[0]).long(), max=tbl.shape[0] - 1)
                        rows_c, count = row_of(c)
                        slot = torch.minimum((block(u[1:]) * count).long(), count - 1)
                        return take(rows_c.index_select(0, slot), c)
            elif sampling == "shuffled_epochs":
                n_batches = n // b
                if n_batches < 1:
                    raise ValueError(f"{n} rows hold no batch of {b}")

                def sample(rng, step_count, sched=None):
                    return take(torch.arange(b, device=dev) + (step_count.long() % n_batches) * b)
            else:
                def sample(rng, step_count, sched=None):
                    return take(block(torch.randint(0, n, (batch_size,), generator=rng,
                                                    device=dev)))
            return sample

        def window(ts, data_x, data_y, rng, do_dis, do_gen, code_batches, schedule, extra):
            if data_x.device != ts.step.device:
                raise ValueError(f"dataset on {data_x.device}, state on {ts.step.device}")
            if scheduled and schedule is None:
                raise ValueError("same_class + shuffled_epochs needs the window's class schedule")
            sample = sampler(data_x, data_y)
            sched = None
            bound = [data_x] + ([] if data_y is None else [data_y]) + extra
            if scheduled:
                sched = stage("schedule", _stacked("schedule rows", schedule, num_steps,
                                                   data_x.device, torch.int64))
            if same_class:
                bound += list(_tables(data_x.device))
            key = _signature(data_x, data_y, sched)
            batch_at = lambda k: sample(rng, ts.step, None if sched is None else sched[k])  # noqa: E731
            generators = [rng] if sampling == "uniform" or (carried and not carried.is_list) else []
            return run(ts, key, batch_at, bound, generators, do_dis, do_gen, code_batches)

        if imbalanced is None:
            def multi_step(ts: TrainState, data_x: torch.Tensor, data_y, rng: torch.Generator,
                           do_dis: bool = True, do_gen: bool = True,
                           code_batches: Optional[Dict] = None, schedule=None):
                return window(ts, data_x, data_y, rng, do_dis, do_gen, code_batches, schedule,
                              [])
        else:
            def multi_step(ts: TrainState, data_x: torch.Tensor, data_y, rng: torch.Generator,
                           mmd_avg: torch.Tensor, code_batches: Optional[Dict] = None):
                carried.set(ts, rng, mmd_avg)
                return window(ts, data_x, data_y, rng, True, True, code_batches, None, [mmd_avg])

        multi_step.sampler = sampler
        multi_step.graphs = run.graphs
        multi_step.dp = dp
        multi_step.with_mesh = make
        return multi_step

    if same_class and class_table.ndim == 3:
        def needs_mesh(*args, **kwargs):
            raise ValueError("sharded class tables (one per rank) need with_mesh(dp)")

        needs_mesh.with_mesh = make
        return needs_mesh
    return make()


class EpochPermuter:
    """Per-epoch dataset layouts for ``sampling='shuffled_epochs'``
    (``mmdgan_tpu/train/step.py:1150-1237``).

    The layout for epoch ``e`` is ``orig[perm(e)]``, with ``perm(e)`` made
    by numpy's ``RandomState`` from the seed, the epoch and (for a mesh
    rank's shard) the rank alone (the same seed formula and permutations
    as the JAX package, so the layouts are bitwise equal to JAX's);
    ``perm(0)`` is the identity, kept as None. A resumed run jumps
    straight to its epoch's layout. Applied as ``delta = inv(perm(prev)) o
    perm(e)``, one ``index_select`` per epoch, written back in place: the
    tensor keeps its buffer, so a CUDA graph that reads it stays valid.

    :param make_perm: e -> np int array [n] for e >= 1
    :param permute: (tensors, delta) -> the same tensors, permuted in place
    """

    def __init__(self, make_perm: Callable, permute: Callable):
        self._make = make_perm
        self._permute = permute
        self.epoch = 0
        self._perm = None

    @staticmethod
    def _perm_seed(seed: int, epoch: int, device: int = 0) -> int:
        """The JAX package's (seed, epoch[, device]) -> RandomState-seed
        derivation."""
        return (seed * 1000003 + epoch * 641 + device * 7919) % (2**31 - 1)

    @staticmethod
    def _permute_(arrs, delta):
        for a in arrs:
            if a is not None:
                a.copy_(a.index_select(0, torch.as_tensor(delta, device=a.device)))
        return arrs

    @classmethod
    def single_device(cls, n: int, seed: int) -> "EpochPermuter":
        """Permuter over an [n, ...] dataset on one device."""

        def make_perm(e):
            return np.random.RandomState(cls._perm_seed(seed, e)).permutation(n)

        return cls(make_perm, cls._permute_)

    @classmethod
    def sharded(cls, local_n: int, ndev: int, seed: int, rank: int) -> "EpochPermuter":
        """Permuter over one rank's shard of ``local_n`` rows of a dataset
        sharded over ``ndev`` ranks: the rank's own permutation stream,
        row ``rank`` of JAX's ``EpochPermuter.sharded`` (``:1195-1218``),
        applied to its rows alone (no traffic between ranks)."""
        if not 0 <= rank < ndev:
            raise ValueError(f"rank {rank} of {ndev}")

        def make_perm(e):
            return np.random.RandomState(cls._perm_seed(seed, e, rank)).permutation(local_n)

        return cls(make_perm, cls._permute_)

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
    [-1, 1], z drawn from ``generator``. A sharded state's weights are
    gathered first, a collective: every rank calls it."""

    def eval_step(ts: TrainState, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        params = ts.params if ts.layout is None else ts.layout.gather(ts)
        return model.generate(params, ts.net_state, generator, batch_size)

    return eval_step
