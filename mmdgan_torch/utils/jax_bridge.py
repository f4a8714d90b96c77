"""Map the JAX package's parameter, state and optimizer trees onto the port's.

The trees come in as numpy (callers run ``jax.device_get`` first), so
this module imports no JAX. Conversions (``utils/tf1_import.py`` does the
inverse permutations and is the model followed here):

- conv kernels HWIO -> OIHW (``c``, ``cck``, the separable conv's
  pointwise kernel); the depthwise kernel ``[k, k, C_in, 1]`` ->
  ``[C_in, 1, k, k]``;
- transposed-conv kernels HWIO (``lax.conv_transpose``) -> torch's
  ``[in, out, k, k]``, spatially flipped (``tc``, ``tcck``);
- dense kernels stay ``[in, out]`` (``d``, ``dcd``, ``dck``; ``dcd``'s
  ``[C, in, out]`` c_kernel too), but where a flatten or an image reshape
  sits next to them the JAX package orders features H-major (h, w, c) and
  the port C-major (c, h, w): rows after a flatten (and ``project``'s
  input features), columns, biases, BN and cbn parameters before an image
  ``out_reshape`` are permuted;
- per-class tables (cbn's scale/offset, ``c_bias``, the cck/tcck scales)
  ``[C, 1, 1, ch]`` -> ``[C, ch, 1, 1]``; over dense features ``[C, F]``
  with the column permutation;
- power vectors NHWC -> NCHW (per class for the conditional ops); a dense
  one gets the permutation of the side it lives on; PIM vectors stay, the
  port's PIM matrix being the JAX package's (``spectral_norm.pim_matrix``);
- optimizer slots like their parameters (optax adam's ``mu``/``nu``,
  ``adam_tf1``'s ``m``/``v``, momentum's ``trace``, rmsprop's ``nu``; bf16
  slots stay bf16), ``count`` as a 0-d int32 tensor (optax adam's count,
  the schedule's of sgd/momentum, ``adam_tf1``'s ``t``; rmsprop has none
  and gets 0);
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
from mmdgan_torch.train.optim import Adam, Optimizer, OptState


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


def _per_class(a: np.ndarray, cols) -> np.ndarray:
    """A per-class table: [C, 1, 1, ch] over images -> [C, ch, 1, 1]; [C, F]
    over dense features with the column permutation."""
    if a.ndim == 4:
        return a.transpose(0, 3, 1, 2)
    return a[:, cols] if cols is not None and a.shape[1] == len(cols) else a


def _dense(a: np.ndarray, rows, cols) -> np.ndarray:
    """A dense kernel [..., in, out] with the row and column permutations."""
    if rows is not None:
        a = a[..., rows, :]
    if cols is not None:
        a = a[..., cols]
    return a


def _conv(a: np.ndarray) -> np.ndarray:          # HWIO -> OIHW
    return a.transpose(3, 2, 0, 1)


def _conv_t(a: np.ndarray) -> np.ndarray:        # HWIO -> [in, out, k, k], flipped
    return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _param(op, name: str, a: np.ndarray, rows, cols) -> np.ndarray:
    """One parameter-shaped array (a parameter or its optimizer slot) of ``op``."""
    kind = op.design["op"]
    if name == "c_kernel":
        if kind == "dcd":
            return _dense(a, rows, cols)
        return _per_class(a, cols)               # dck [C, out]; cck/tcck [C, 1, 1, out]
    if name == "kernel":
        if kind in ("d", "dcd", "dck"):
            return _dense(a, rows, cols)
        if kind == "project":                    # [C, in]: the input features
            return a if rows is None else a[:, rows]
        if kind in ("c", "cck"):
            return _conv(a)
        if kind in ("tc", "tcck"):
            return _conv_t(a)
        if kind == "k":
            return a
    if name == "depthwise_kernel":               # [k, k, C_in, 1] -> [C_in, 1, k, k]
        return a.transpose(2, 3, 0, 1)
    if name == "pointwise_kernel":
        return _conv(a)
    if name in ("scale", "offset", "c_bias"):
        return _per_class(a, cols)
    if name in ("bias", "gamma", "beta"):
        return _per_feature(a, cols)
    raise NotImplementedError(f"bridge: {kind} parameter {name} is not ported")


def _state(op, name: str, a: np.ndarray, rows, cols) -> np.ndarray:
    """One state array of ``op``: BN statistics, or a power vector (NHWC ->
    NCHW per class; a dense one with the permutation of its side; a PIM
    vector, which lives in the JAX package's matrix layout, as it is)."""
    if name != "sn_x":
        return _per_feature(a, cols)   # BN statistics
    if op.use_pim:
        return a
    if a.ndim == 4:
        return a.transpose(0, 3, 1, 2)
    if op.design["op"] == "project":   # output side: the classes
        perm = rows if use_u(op.sn_def) else None
    else:
        perm = rows if use_u(op.sn_def) else cols
    return a if perm is None else a[..., perm]


def _convert(model: SNGan, tree: Dict, leaf_fn, device, dtype=torch.float32) -> Dict:
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
                        device=device).to(dtype)
                    for name, a in src[op_name].items()}
                for op_name, op in layer.ops.items() if op_name in src}
    return out


def _optax_parts(opt_state) -> Tuple:
    """(count or None, {field: tree}) of an optax state of the JAX
    package's optimizers: a chain's tuple of states, one state, or
    ``adam_tf1``'s dict."""
    if isinstance(opt_state, dict):
        return opt_state["t"], {"m": opt_state["m"], "v": opt_state["v"]}
    parts = (opt_state if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields")
             else (opt_state,))
    count, fields = None, {}
    for part in parts:
        for name in getattr(part, "_fields", ()):
            if name == "count":
                count = getattr(part, name) if count is None else count
            else:
                fields[name] = getattr(part, name)
    return count, fields


def _opt_state(model: SNGan, opt_state, opt: Optimizer, net_key: str, device) -> OptState:
    """The slots ``opt`` keeps, taken from an optax state, as an OptState."""
    count, fields = _optax_parts(opt_state)
    dtype = torch.bfloat16 if opt.bf16_slots else torch.float32
    conv = lambda tree: _convert(model, {net_key: tree}, _param, device, dtype)[net_key]
    count = 0 if count is None else int(np.asarray(count))
    return OptState(count=torch.tensor(count, dtype=torch.int32, device=device),
                    slots={name: conv(fields[name]) for name in opt.slot_names})


def jax_params_to_torch(model: SNGan, params: Dict, net_state: Dict,
                        opt_states: Optional[Tuple] = None, device="cpu",
                        loss_state=None, optimizers: Optional[Tuple] = None):
    """Convert numpy trees of the JAX package into the port's layout.

    :param model: the port's SNGan of the same architecture
    :param opt_states: optional ``(opt_state_dis, opt_state_gen)`` of the
        JAX package's optimizers
    :param optimizers: the port's ``(opt_dis, opt_gen)`` for ``opt_states``,
        which say what slots to keep and their dtype; Adam when not given
    :param loss_state: optional JAX ``LossState`` (any object with its
        three fields)
    :returns: ``(params, net_state)``, plus ``(OptState dis, OptState gen)``
        when ``opt_states`` is given, plus the port's ``LossState`` when
        ``loss_state`` is given
    """
    out = (_convert(model, params, _param, device), _convert(model, net_state, _state, device))
    if opt_states is not None:
        opts = optimizers if optimizers is not None else (Adam(0.0), Adam(0.0))
        out += (tuple(_opt_state(model, state, opt, net_key, device)
                      for state, opt, net_key in zip(opt_states, opts, ("dis", "gen"))),)
    if loss_state is not None:
        out += (LossState(**{f.name: torch.tensor(np.asarray(getattr(loss_state, f.name)),
                                                  dtype=torch.float32, device=device)
                             for f in dataclasses.fields(LossState)}),)
    return out


def jax_random_classifier_to_torch(kernels, w_pool, w_log, device="cpu"):
    """The JAX package's ``RandomFeatureClassifier`` weights (its four HWIO
    conv kernels, ``w_pool``, ``w_log``, as numpy; ``inception.py:150-180``)
    in the port's ``RandomFeatureClassifier`` on ``device``."""
    from mmdgan_torch.metrics.inception import RandomFeatureClassifier

    w_pool, w_log = np.asarray(w_pool, np.float32), np.asarray(w_log, np.float32)
    return RandomFeatureClassifier(
        pool_dim=w_pool.shape[1], num_logits=w_log.shape[1], device=device,
        weights=([np.asarray(k, np.float32) for k in kernels], w_pool, w_log))
