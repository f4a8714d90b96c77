"""Train-step builders (``mmdgan_tpu/train/step.py:41-154,476-504,657-1237``).

- ``build_train_step``: one step. One generator forward and one
  discriminator forward on concat(real, fake). ``grads_dis`` comes from
  ``loss_dis``, ``grads_gen`` from ``loss_gen`` through the generated
  images; both are taken before either update. ``do_dis``/``do_gen`` gate
  the updates with a Python ``if``, so a skipped update leaves its
  optimizer slots untouched; SN vectors and BN statistics update every
  step. The step updates the TrainState in place, every tensor in its own
  buffer, and returns it with the step's metrics as 0-d tensors on the
  device; reading them is the caller's choice, so the step itself never
  waits for the device.
- ``graph_steps``: K calls of a step as one CUDA graph launch, the
  counterpart of one ``lax.scan`` launch (``StepGraphs`` says how the
  graphs are made); on the CPU, or with ``capture=False``, an eager loop.
- ``build_multi_step``: ``graph_steps`` of the train step over a K-stacked
  batch.
- ``build_device_data_step``: K steps whose batches are taken on the
  device from a dataset that lives there, the sampler inside the graph;
  it shares ``graph_steps``' window runner (``_window_runner``).
- ``EpochPermuter``: the per-epoch layouts of ``sampling='shuffled_epochs'``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mmdgan_torch import DeviceLike, check_device
from mmdgan_torch.models.sngan import SNGan, decode_image_batch, to_nchw
from mmdgan_torch.train.optim import Adam
from mmdgan_torch.train.state import TrainState, copy_tree_, loss_state_leaves, tree_leaves


def init_train_state(model: SNGan, seed: int, opt_dis: Adam, opt_gen: Adam,
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


def _grads(loss: torch.Tensor, leaves, retain_graph: bool = False):
    """d loss / d leaves; zeros for a constant loss (the 'test' loss)."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in leaves]
    return torch.autograd.grad(loss, leaves, retain_graph=retain_graph)


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def build_train_step(model: SNGan, opt_dis: Adam, opt_gen: Adam,
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
        if do_dis:
            opt_dis.update_(dis_leaves, grads_dis, ts.opt_state_dis)
        if do_gen:
            opt_gen.update_(gen_leaves, grads_gen, ts.opt_state_gen)
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
    run = _window_runner(step, num_steps, capture)
    staged: Dict = {}

    def multi_step(ts: TrainState, batches: Dict, do_dis: bool = True, do_gen: bool = True,
                   code_batches: Optional[Dict] = None):
        xs = _stacked("batches", batches["x"], num_steps, ts.step.device)
        key = (tuple(xs.shape), xs.dtype)
        if key not in staged:
            staged[key] = torch.empty_like(xs)
        x_buf = staged[key]
        x_buf.copy_(xs, non_blocking=True)
        return run(ts, key, lambda k: {"x": x_buf[k]}, [], [], do_dis, do_gen, code_batches)

    multi_step.graphs = run.graphs
    return multi_step


def build_multi_step(model: SNGan, opt_dis: Adam, opt_gen: Adam, num_steps: int,
                     device: DeviceLike = None, capture: Optional[bool] = None) -> Callable:
    """K train steps per call over a K-stacked batch (``graph_steps`` of
    ``build_train_step``): one CUDA graph launch per call on CUDA, the
    counterpart of one ``lax.scan`` launch."""
    return graph_steps(build_train_step(model, opt_dis, opt_gen, device), num_steps, capture)


def build_device_data_step(
    model: SNGan,
    opt_dis: Adam,
    opt_gen: Adam,
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
    ``sample(rng, step) -> batch``. Same-class sampling and micro-batches
    (ROADMAP A12) and the mesh (``with_mesh``, ROADMAP A15) raise."""
    if same_class:
        raise NotImplementedError("same-class sampling is not ported yet (ROADMAP A12)")
    if int(micro_batches) != 1:
        raise NotImplementedError("micro-batches are not ported yet (ROADMAP A12)")
    if sampling not in ("uniform", "shuffled_epochs"):
        raise ValueError(f"unknown sampling {sampling!r}")
    run = _window_runner(build_train_step(model, opt_dis, opt_gen, device), num_steps, capture)

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
