"""The port's spectral norm (one PICO power-iteration step) against the
JAX package's ``spectral_norm_apply``, for every layer shape of the
cifar discriminator and for transposed convs with the vector on either
side.

Same numpy kernel and power vector on both sides (converted by the
bridge's layouts). Tolerances: sigma rtol 1e-5; its kernel gradient
rtol 1e-5 / atol 1e-6, the atol for entries near zero that are sums over
a whole image and cancel (largest entries ~0.15); the new power vector
rtol 1e-4 / atol 1e-6 (it is a normalized map of the old one through two
float32 convs, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.ops.spectral_norm import SnDef as JaxSnDef
from mmdgan_tpu.ops.spectral_norm import spectral_norm_apply as jax_sn_apply
from mmdgan_torch.ops.conv import Geometry
from mmdgan_torch.ops.spectral_norm import SnDef, spectral_norm_apply, use_u

torch.set_num_threads(1)

# (name, op, input HWC / (F,), output HWC / (F,), kernel size, stride)
CASES = [
    ("l1_f32", "c", (32, 32, 3), (32, 32, 64), 3, 1),       # vector in input space
    ("l2_ds", "c", (32, 32, 64), (16, 16, 128), 4, 2),      # output space
    ("l3", "c", (16, 16, 128), (16, 16, 128), 3, 1),
    ("l4_ds", "c", (16, 16, 128), (8, 8, 256), 4, 2),
    ("l5", "c", (8, 8, 256), (8, 8, 256), 3, 1),
    ("l6_ds", "c", (8, 8, 256), (4, 4, 512), 4, 2),
    ("l7", "c", (4, 4, 512), (4, 4, 512), 3, 1),
    ("l8_s", "d", (8192,), (16,), None, 1),                  # dense, output space
    ("dense_in", "d", (16,), (64,), None, 1),                # dense, input space
    ("dense_rank1", "d", (64,), (1,), None, 1),              # closed form
    ("tc_in", "tc", (4, 4, 32), (8, 8, 16), 4, 2),           # tc, input space
    ("tc_out", "tc", (8, 8, 32), (16, 16, 4), 4, 2),         # tc, output space
]


def _chw(shape):
    return (shape[2], shape[0], shape[1]) if len(shape) == 3 else shape


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_spectral_norm_matches_jax(case):
    name, op, ish, osh, k, s = case
    rng = np.random.RandomState(CASES.index(case))
    if op == "d":
        w = (rng.randn(ish[0], osh[0]) / np.sqrt(ish[0])).astype(np.float32)
        w_t = w
    else:
        cin = ish[2]
        cout = osh[2]
        w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
        w_t = (w.transpose(3, 2, 0, 1) if op == "c"
               else w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy())
    jsn = JaxSnDef(op=op, input_shape=ish, output_shape=osh, strides=s)
    geometry = None if op == "d" else Geometry.make(op, ish[:2], k, s)
    sn = SnDef(op=op, input_shape=_chw(ish), output_shape=_chw(osh), geometry=geometry)
    side = ish if use_u(sn) else osh
    # an unnormalized truncated normal, as a fresh power vector is
    x = np.clip(rng.randn(1, *side), -2, 2).astype(np.float32)
    x_t = x.transpose(0, 3, 1, 2) if x.ndim == 4 else x

    def jax_sigma(kernel):
        return jax_sn_apply(kernel, jnp.asarray(x), jsn)

    (sigma_j, x_new_j), vjp = jax.vjp(jax_sigma, jnp.asarray(w))
    (grad_j,) = vjp((jnp.ones(()), jnp.zeros_like(x_new_j)))

    kernel = torch.tensor(w_t, requires_grad=True)
    sigma, x_new = spectral_norm_apply(kernel, torch.tensor(x_t), sn)
    (grad,) = torch.autograd.grad(sigma, kernel)

    np.testing.assert_allclose(sigma.item(), float(sigma_j), rtol=1e-5)
    x_new_j = np.asarray(x_new_j)
    if x_new_j.ndim == 4:
        x_new_j = x_new_j.transpose(0, 3, 1, 2)
    assert tuple(x_new.shape) == x_new_j.shape
    assert not x_new.requires_grad
    np.testing.assert_allclose(x_new.numpy(), x_new_j, rtol=1e-4, atol=1e-6)
    grad_j = np.asarray(grad_j)
    if op == "c":
        grad_j = grad_j.transpose(3, 2, 0, 1)
    elif op == "tc":
        grad_j = grad_j.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    np.testing.assert_allclose(grad.numpy(), grad_j, rtol=1e-5, atol=1e-6)
