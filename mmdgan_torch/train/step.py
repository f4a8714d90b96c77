"""The train step (``mmdgan_tpu/train/step.py:41-154,476-504``).

One generator forward and one discriminator forward on concat(real,
fake). ``grads_dis`` comes from ``loss_dis``, ``grads_gen`` from
``loss_gen`` through the generated images; both are taken before either
update. ``do_dis``/``do_gen`` gate the updates with a Python ``if``, so a
skipped update leaves its optimizer slots untouched; SN vectors and BN
statistics update every step.

The step updates the TrainState in place (see ``TrainState``) and returns
it with the step's metrics as 0-d tensors on the device; reading them is
the caller's choice, so the step itself never waits for the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mmdgan_torch import DeviceLike, check_device
from mmdgan_torch.models.sngan import SNGan, decode_image_batch, to_nchw
from mmdgan_torch.train.optim import Adam
from mmdgan_torch.train.state import TrainState, tree_leaves


def init_train_state(model: SNGan, seed: int, opt_dis: Adam, opt_gen: Adam,
                     device: DeviceLike = None) -> TrainState:
    """Fresh state from ``seed``: the model's init and the step's z stream."""
    dev = check_device(model.device, device)
    params, net_state, loss_state = model.init(seed)
    return TrainState(
        params=params, net_state=net_state, loss_state=loss_state,
        opt_state_dis=opt_dis.init(params["dis"]),
        opt_state_gen=opt_gen.init(params["gen"]),
        step=0, rng=torch.Generator(dev).manual_seed(int(seed) + 1))


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def build_train_step(model: SNGan, opt_dis: Adam, opt_gen: Adam,
                     device: DeviceLike = None) -> Callable:
    """Returns ``train_step(ts, data_batch, do_dis=True, do_gen=True,
    code_batch=None) -> (ts, metrics)``. ``data_batch['x']`` is NHWC
    ([B, H, W, C], float in [-1, 1] or uint8); ``code_batch={'x': z}``
    replaces the z draw, as ``gen_stage(code_batch=...)`` does in JAX."""
    dev = check_device(model.device, device)

    def train_step(ts: TrainState, data_batch: Dict, do_dis: bool = True,
                   do_gen: bool = True, code_batch: Optional[Dict] = None):
        x = torch.as_tensor(data_batch["x"], device=dev)
        x = to_nchw(decode_image_batch({"x": x})["x"])
        gen_x, gen_state, _ = model.gen_stage(
            ts.params["gen"], ts.net_state, x.shape[0], ts.rng, code_batch)
        loss_gen, loss_dis, dis_state, new_loss_state, aux = model.dis_stage(
            ts.params["dis"], gen_x, ts.net_state, ts.loss_state, x)
        dis_leaves = tree_leaves(ts.params["dis"])
        gen_leaves = tree_leaves(ts.params["gen"])
        grads_dis = torch.autograd.grad(loss_dis, dis_leaves, retain_graph=True)
        grads_gen = torch.autograd.grad(loss_gen, gen_leaves)
        if do_dis:
            opt_dis.update_(dis_leaves, grads_dis, ts.opt_state_dis)
        if do_gen:
            opt_gen.update_(gen_leaves, grads_gen, ts.opt_state_gen)
        ts.net_state = {"gen": gen_state, "dis": dis_state}
        ts.loss_state = new_loss_state
        ts.step += 1
        metrics = {"loss_gen": loss_gen.detach(), "loss_dis": loss_dis.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        if model.do_summary:
            metrics["grad_norm_dis"] = _global_norm(grads_dis)
            metrics["grad_norm_gen"] = _global_norm(grads_gen)
        return ts, metrics

    return train_step


def build_multi_step(model: SNGan, opt_dis: Adam, opt_gen: Adam, num_steps: int,
                     device: DeviceLike = None) -> Callable:
    """K train steps per call over a K-stacked batch (``{'x': [K, B, H, W, C]}``);
    returns the final state and the per-step metrics stacked along axis 0."""
    step = build_train_step(model, opt_dis, opt_gen, device)

    def multi_step(ts: TrainState, batches: Dict, do_dis: bool = True, do_gen: bool = True):
        xs = batches["x"]
        if len(xs) != num_steps:
            raise ValueError(f"expected {num_steps} stacked batches, got {len(xs)}")
        per_step = []
        for k in range(num_steps):
            ts, m = step(ts, {"x": xs[k]}, do_dis, do_gen)
            per_step.append(m)
        return ts, {key: torch.stack([m[key] for m in per_step]) for key in per_step[0]}

    return multi_step
