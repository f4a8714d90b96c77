"""Import the reference's TF1 checkpoints into the port's parameters and
state, the counterpart of ``mmdgan_tpu/utils/tf1_import.py``, with no
TensorFlow (``utils/tf_bundle.py`` reads the bundle).

The reference's variable names follow from its scoping (layer_func.py:878,
699, 727-777; the graph is built under tf.variable_scope):

    {net}/{layer}/kernel/kernel            dense/conv/tc weights
    {net}/{layer}/kernel/SN/in_rand        spectral-norm power vector
    {net}/{layer}/bias/bias                bias
    {net}/{layer}/BN/BN/{gamma,beta,moving_mean,moving_variance}
    (res blocks: kernel_0/kernel, bias_0/bias, BN_0/BN/..., kernel_sc/...)

Layouts, derived for the port's NCHW (ROADMAP C8):

- Convolution kernels: TF stores HWIO ``[k, k, in, out]``, torch OIHW:
  ``transpose(3, 2, 0, 1)``. TF's ``conv2d_transpose`` takes
  ``[k, k, out, in]`` and computes ``conv2d``'s adjoint, as torch's
  ``conv_transpose2d`` does with ``[in, out, k, k]``: the same
  ``transpose(3, 2, 0, 1)``, with no spatial flip (the JAX package needs
  one for ``lax.conv_transpose``). The depthwise kernel ``[k, k, C, 1]`` is
  ``[C, 1, k, k]`` here.
- An NCHW checkpoint (the reference's default, misc_fun.py:50) flattens
  images C-major, as the port does, and keeps its per-class tables and
  power vectors channels-first, as the port does: nothing else moves.
- An NHWC checkpoint orders flat features H-major and tables
  channels-last, the JAX package's layout: the bridge's permutations apply
  (``utils/jax_bridge.py``: dense rows after a flatten, columns, biases, BN
  parameters and statistics before an image reshape, per-class tables,
  power vectors).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mmdgan_torch.utils.jax_bridge import _layer_perms, _param, _state

# the reference's variable name under the op's scope, by the port's leaf name
_NAMES = {"kernel": "kernel", "bias": "bias", "c_bias": "c_bias", "c_kernel": "c_kernel",
          "scale": "scale", "offset": "offset", "depthwise_kernel": "depthwise_kernel",
          "pointwise_kernel": "pointwise_kernel", "gamma": "BN/gamma", "beta": "BN/beta",
          "moving_mean": "BN/moving_mean", "moving_var": "BN/moving_variance"}
_CONV = ("c", "cck", "tc", "tcck")


class TF1CheckpointImporter:
    """Map a {tf_name: array} dict onto the (params, state) of one Routine.

    :param routine: the port's built Routine (``model.Gen`` or ``model.Dis``)
    :param data_format: layout of the checkpoint, 'NCHW' (the reference's
        default) or 'NHWC'
    """

    def __init__(self, routine, data_format: str = "NCHW"):
        self.routine = routine
        self.nhwc = data_format in ("NHWC", "channels_last")

    @staticmethod
    def _get(variables: Dict, name: str) -> np.ndarray:
        if name not in variables:
            scope = name.split("/")[1] if "/" in name else name
            raise KeyError(f"checkpoint variable '{name}' not found; near misses: "
                           f"{[v for v in variables if scope in v][:6]}")
        return np.asarray(variables[name])

    def _array(self, op, name: str, a: np.ndarray, rows, cols) -> np.ndarray:
        """One reference array in the port's layout."""
        kind = op.design["op"]
        if (name == "kernel" and kind in _CONV) or name == "pointwise_kernel":
            return a.transpose(3, 2, 0, 1)
        if name == "depthwise_kernel":
            return a.transpose(2, 3, 0, 1)
        if not self.nhwc:
            return a
        if name in ("sn_x", "moving_mean", "moving_var"):
            return _state(op, name, a, rows, cols)
        return _param(op, name, a, rows, cols)

    def _leaf(self, variables: Dict, base: str, op, name: str, like: torch.Tensor, rows, cols):
        src = f"{base}/SN/in_rand" if name == "sn_x" else f"{base}/{_NAMES[name]}"
        a = np.array(self._array(op, name, self._get(variables, src), rows, cols))
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"{src}: checkpoint shape {a.shape} in the port's layout, "
                             f"the model's {tuple(like.shape)}")
        return torch.tensor(a, dtype=like.dtype, device=like.device)

    def apply(self, params: Dict, state: Dict, variables: Dict[str, np.ndarray]):
        """(new params, new state) of the routine with the checkpoint's values.

        Every parameter must be in ``variables`` (strict). A power vector
        the checkpoint lacks keeps its value: the reference creates none
        where its sigma has a closed form (math_func.py:700-721), and the
        port's closed form ignores the vector too."""
        new_params = {k: dict(v) for k, v in params.items()}
        new_state = {k: dict(v) for k, v in state.items()}
        layers = self.routine.net.layers
        for i in self.routine.layer_indices:
            layer = layers[i]
            scope = layer.layer_scope
            rows, cols = (_layer_perms(layer, layers[i - 1] if i > 0 else None)
                          if self.nhwc else (None, None))
            for op_name, op in layer.ops.items():
                if not hasattr(op, "design"):
                    continue   # image scaling: no variables
                base = f"{scope}/{op_name}"
                p = dict(params.get(scope, {}).get(op_name, {}))
                s = dict(state.get(scope, {}).get(op_name, {}))
                for name in p:
                    p[name] = self._leaf(variables, base, op, name, p[name], rows, cols)
                for name in s:
                    if name == "sn_x" and f"{base}/SN/in_rand" not in variables:
                        continue
                    s[name] = self._leaf(variables, base, op, name, s[name], rows, cols)
                if p:
                    new_params.setdefault(scope, {})[op_name] = p
                if s:
                    new_state.setdefault(scope, {})[op_name] = s
        return new_params, new_state


def load_tf1_checkpoint(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF1 checkpoint (a prefix, or a folder with a
    ``checkpoint`` file), read without TensorFlow."""
    from mmdgan_torch.utils.tf_bundle import TFBundle

    return TFBundle(ckpt_path).tensors()


def import_reference_checkpoint(model, params: Dict, state: Dict, ckpt_path_or_vars,
                                data_format: str = "NCHW"):
    """The reference SNGan checkpoint's values in (params, state) of the
    port's model, on the tensors' devices.

    :param model: the port's SNGan (its architecture the checkpoint's)
    :param ckpt_path_or_vars: a checkpoint prefix or folder, or a
        {name: array} dict
    """
    variables = (ckpt_path_or_vars if isinstance(ckpt_path_or_vars, dict)
                 else load_tf1_checkpoint(ckpt_path_or_vars))
    pg, sg = TF1CheckpointImporter(model.Gen, data_format).apply(
        params["gen"], state["gen"], variables)
    pd, sd = TF1CheckpointImporter(model.Dis, data_format).apply(
        params["dis"], state["dis"], variables)
    return {"gen": pg, "dis": pd}, {"gen": sg, "dis": sd}
