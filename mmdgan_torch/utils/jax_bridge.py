"""Map the JAX package's parameter, state and Adam trees onto the port's.

The trees come in as numpy (callers run ``jax.device_get`` first), so
this module imports no JAX. Conversions (``utils/tf1_import.py`` does the
inverse permutations and is the model followed here):

- conv kernels HWIO -> OIHW;
- transposed-conv kernels HWIO (``lax.conv_transpose``) -> torch's
  ``[in, out, k, k]``, spatially flipped;
- dense kernels stay ``[in, out]``, but where a flatten or an image
  reshape sits next to them the JAX package orders features H-major
  (h, w, c) and the port C-major (c, h, w): rows after a flatten, columns
  and bias before an image ``out_reshape`` are permuted;
- power vectors NHWC -> NCHW; a dense one gets the permutation of the
  side it lives on;
- Adam ``mu``/``nu`` like their parameters, ``count`` as a 0-d int32
  tensor;
- the ``LossState`` (moving loss average, mix probability, instance-noise
  sigma) as 0-d float32 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mmdgan_torch.models.layers import Layer
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops.losses import LossState
from mmdgan_torch.ops.spectral_norm import use_u
from mmdgan_torch.train.optim import AdamState


def hwc_to_chw_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[j_port] = j_jax for flat features: the port's (c, h, w)
    row-major index to the JAX package's (h, w, c) one."""
    return np.arange(c * h * w).reshape(h, w, c).transpose(2, 0, 1).reshape(-1)


def _layer_perms(layer: Layer, prev: Optional[Layer]) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(row perm, column perm) of the layer's dense kernel, or None each."""
    rows = cols = None
    if (prev is not None and prev.design["out_reshape"] is not None
            and len(prev.design["out_reshape"]) == 1
            and len(prev.pre_out_reshape_shape) == 3):
        rows = hwc_to_chw_perm(*prev.pre_out_reshape_shape)
    elif (layer.design["in_reshape"] is not None and len(layer.design["in_reshape"]) == 1
            and len(layer.input_shape) == 3):
        rows = hwc_to_chw_perm(*layer.input_shape)
    out = layer.design["out_reshape"]
    if out is not None and len(out) == 3:
        cols = hwc_to_chw_perm(*out)
    return rows, cols


def _per_feature(a: np.ndarray, cols) -> np.ndarray:
    """A bias or BN vector over the layer's flat output features, in the
    port's order (a per-channel vector of a conv is left as it is)."""
    return a[cols] if cols is not None and a.shape[0] == len(cols) else a


def _param(op, name: str, a: np.ndarray, rows, cols) -> np.ndarray:
    """One parameter-shaped array (a parameter or its Adam slot) of ``op``."""
    op_kind = op.design["op"]
    if op_kind == "d":
        if rows is not None:
            a = a[rows, :]
        if cols is not None:
            a = a[:, cols]
        return a
    if op_kind == "c":
        return a.transpose(3, 2, 0, 1)
    if op_kind == "tc":
        return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if op_kind in ("b", "bias", "bn"):
        return _per_feature(a, cols)
    raise NotImplementedError(f"bridge: op {op_kind} is not ported")


def _state(op, name: str, a: np.ndarray, rows, cols) -> np.ndarray:
    if name != "sn_x":
        return _per_feature(a, cols)   # BN statistics
    if a.ndim == 4:
        return a.transpose(0, 3, 1, 2)
    perm = rows if use_u(op.sn_def) else cols
    return a if perm is None else a[:, perm]


def _convert(model: SNGan, tree: Dict, leaf_fn, device) -> Dict:
    out: Dict = {}
    for net_key, routine in (("gen", model.Gen), ("dis", model.Dis)):
        out[net_key] = {}
        layers = routine.net.layers
        for i, layer in enumerate(layers):
            src = tree.get(net_key, {}).get(layer.layer_scope)
            if src is None:
                continue
            rows, cols = _layer_perms(layer, layers[i - 1] if i > 0 else None)
            out[net_key][layer.layer_scope] = {
                op_name: {
                    name: torch.tensor(np.ascontiguousarray(
                        leaf_fn(op, name, np.asarray(a, np.float32), rows, cols)),
                        device=device)
                    for name, a in src[op_name].items()}
                for op_name, op in layer.ops.items() if op_name in src}
    return out


def _adam(model: SNGan, opt_state, net_key: str, device) -> AdamState:
    """The ``ScaleByAdamState`` inside an optax adam state, as AdamState."""
    slots = opt_state if hasattr(opt_state, "mu") else next(
        s for s in opt_state if hasattr(s, "mu"))
    conv = lambda tree: _convert(model, {net_key: tree}, _param, device)[net_key]
    count = torch.tensor(int(np.asarray(slots.count)), dtype=torch.int32, device=device)
    return AdamState(count=count, mu=conv(slots.mu), nu=conv(slots.nu))


def jax_params_to_torch(model: SNGan, params: Dict, net_state: Dict,
                        opt_states: Optional[Tuple] = None, device="cpu",
                        loss_state=None):
    """Convert numpy trees of the JAX package into the port's layout.

    :param model: the port's SNGan of the same architecture
    :param opt_states: optional ``(opt_state_dis, opt_state_gen)`` of optax adam
    :param loss_state: optional JAX ``LossState`` (any object with its
        three fields)
    :returns: ``(params, net_state)``, plus ``(AdamState dis, AdamState gen)``
        when ``opt_states`` is given, plus the port's ``LossState`` when
        ``loss_state`` is given
    """
    out = (_convert(model, params, _param, device), _convert(model, net_state, _state, device))
    if opt_states is not None:
        out += ((_adam(model, opt_states[0], "dis", device),
                 _adam(model, opt_states[1], "gen", device)),)
    if loss_state is not None:
        out += (LossState(**{f.name: torch.tensor(np.asarray(getattr(loss_state, f.name)),
                                                  dtype=torch.float32, device=device)
                             for f in dataclasses.fields(LossState)}),)
    return out
