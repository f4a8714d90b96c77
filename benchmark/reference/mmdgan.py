"""Plain float32 reference of the repulsive-loss MMD-GAN (Wang et al.,
"Improving MMD-GAN Training with Repulsive Loss Function", ICLR 2019;
richardwth/MMD-GAN), for the DCGAN-style families of the benchmark's
configurations: a generator of dense, transposed-conv, batch-norm and
conv layers, and a discriminator of spectrally normalised conv and dense
layers.

Written from the published description and the reference scripts, in
plain PyTorch: no kernel, no graph, no batching trick. Every leaf is a
float32 tensor named ``<net>/<layer>/<op>/<leaf>`` after the original's
variable scopes. Layouts are torch's: dense ``[in, out]``, conv ``[out,
in, k, k]``, transposed conv ``[in, out, k, k]``.

- Spectral norm by power iteration on the layer operator (PICO): one
  iteration per call; the power vector lives in the smaller of the layer's
  input and output spaces; sigma keeps its gradient to the kernel, the new
  vector is detached. A layer's kernel is multiplied by ``act_k / (sigma
  + 1e-10)``.
- Batch norm as ``tf.layers``: the biased batch variance, eps 1e-3, moving
  statistics with momentum 0.99.
- The repulsive loss: Gaussian kernel means (sigma 1) off the diagonal of
  the gen-gen (xx), gen-data (xy) and data-data (yy) matrices;
  ``loss_gen = e_kxx + e_kyy - 2 e_kxy`` and ``loss_dis = w0 e_kxy - e_kxx
  - w1 e_kyy``.
- Adam as optax: ``p -= lr mu_hat / (sqrt(nu_hat) + eps)``.

``precision="fp8"`` is the control, computed in the next precision below
the configuration's bfloat16: every operand and every output of the
networks' convs and matrix products is rounded to float8 e4m3 with a
per-tensor scale, and every gradient that flows back into them to e5m2.

Inside ``float32_exact()`` (TF32 off) a float32 conv or matrix product
on the card computes in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
BN_MOMENTUM = 0.99
BN_EPS = 1e-3
SN_EPS = 1e-10
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def float32_exact():
    """float32 convs and matrix products in float32 on the card (TF32 off),
    the flags restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# layers from the architecture dict
# ---------------------------------------------------------------------------
def _same_pad(k: int, s: int, n: int) -> int:
    """Symmetric SAME pad of a conv (every layer of these families)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    if total % 2:
        raise ValueError(f"asymmetric SAME padding (k={k}, s={s}, n={n}) is not covered")
    return total // 2


def layers(arch: dict, net: str) -> List[dict]:
    """The net's layers with their shapes: op ('d', 'c' or 'tc'), in and
    out shapes (channels-first), kernel, stride, pad, and whether the
    layer has a bias, a batch norm, spectral norm and which act_k."""
    key = "generator" if net == "gen" else "discriminator"
    shape = (arch["code"][0][0],) if net == "gen" else tuple(arch["input"][0])
    out = []
    for d in arch[key]:
        op = d.get("op", "c")
        bn = d.get("act_nm") in ("bn", "BN")
        spec = {"name": f"{net}/{d['name']}", "op": op, "in": tuple(shape),
                "act": d.get("act", "linear"), "bn": bn,
                "bias": d.get("bias", "b") in ("b", "bias") and not bn,
                "sn": d.get("w_nm") == "s", "out_reshape": d.get("out_reshape")}
        act_k = d.get("act_k", False)
        spec["act_k"] = float(act_k) if isinstance(act_k, (int, float)) and not isinstance(
            act_k, bool) else 1.0
        if op == "d":
            if len(shape) != 1:
                raise ValueError(f"{spec['name']}: dense input must be flat, got {shape}")
            spec["out"] = (d["out"],)
            spec["kernel_shape"] = (shape[0], d["out"])
            spec["fan_in"], spec["fan_out"] = shape[0], d["out"]
        elif op in ("c", "tc"):
            k, s = d.get("kernel", 3), d.get("strides", 1)
            c_in, h, w = shape
            if op == "c":
                pad = _same_pad(k, s, h)
                spec["out"] = (d["out"], -(-h // s), -(-w // s))
                spec["kernel_shape"] = (d["out"], c_in, k, k)
            else:
                if (k, s) != (4, 2):
                    raise ValueError(f"{spec['name']}: only the k4/s2 transposed conv is covered")
                pad = 1
                spec["out"] = (d["out"], h * s, w * s)
                spec["kernel_shape"] = (c_in, d["out"], k, k)
            spec.update(kernel=k, stride=s, pad=pad)
            spec["fan_in"] = spec["kernel_shape"][1] * k * k
            spec["fan_out"] = spec["kernel_shape"][0] * k * k
        else:
            raise ValueError(f"{spec['name']}: op {op} is not covered by the reference")
        shape = tuple(spec["out"]) if spec["out_reshape"] is None else tuple(spec["out_reshape"])
        out.append(spec)
    return out


def leaf_specs(arch: dict) -> Dict[str, dict]:
    """Every leaf of the model: name -> {shape, group ('param', 'sn',
    'bn_state'), and for kernels the fans and the activation}."""
    specs: Dict[str, dict] = {}
    for net in ("gen", "dis"):
        for L in layers(arch, net):
            n = L["name"]
            specs[f"{n}/kernel/kernel"] = {"shape": L["kernel_shape"], "group": "param",
                                           "kind": "kernel", "fan_in": L["fan_in"],
                                           "fan_out": L["fan_out"], "act": L["act"]}
            c = L["out"][0]
            if L["bias"]:
                specs[f"{n}/bias/bias"] = {"shape": (c,), "group": "param", "kind": "bias"}
            if L["bn"]:
                specs[f"{n}/BN/gamma"] = {"shape": (c,), "group": "param", "kind": "gamma"}
                specs[f"{n}/BN/beta"] = {"shape": (c,), "group": "param", "kind": "beta"}
                specs[f"{n}/BN/moving_mean"] = {"shape": (c,), "group": "bn_state",
                                                "kind": "moving_mean"}
                specs[f"{n}/BN/moving_var"] = {"shape": (c,), "group": "bn_state",
                                               "kind": "moving_var"}
            if L["sn"]:
                specs[f"{n}/kernel/sn_x"] = {"shape": (1,) + tuple(_sn_space(L)),
                                             "group": "sn", "kind": "sn_x"}
    return specs


def _sn_space(L: dict) -> tuple:
    n_in, n_out = math.prod(L["in"]), math.prod(L["out"])
    return L["in"] if n_in <= n_out else L["out"]


# ---------------------------------------------------------------------------
# precision of the control
# ---------------------------------------------------------------------------
def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 backward, each with a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"precision {precision} is not covered")


def _linear(L: dict, x: torch.Tensor, w: torch.Tensor, precision: str = "float32"):
    x, w = _operand(x, precision), _operand(w, precision)
    if L["op"] == "d":
        y = x @ w
    elif L["op"] == "c":
        y = F.conv2d(x, w, stride=L["stride"], padding=L["pad"])
    else:
        y = F.conv_transpose2d(x, w, stride=L["stride"], padding=L["pad"])
    return _operand(y, precision)


def _adjoint(L: dict, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The adjoint of the layer's linear map (no precision change)."""
    if L["op"] == "d":
        return y @ w.T
    if L["op"] == "c":
        return F.conv_transpose2d(y, w, stride=L["stride"], padding=L["pad"])
    return F.conv2d(y, w, stride=L["stride"], padding=L["pad"])


def power_iteration(L: dict, w: torch.Tensor, u: torch.Tensor):
    """(sigma with its gradient to ``w``, the new unit vector, detached)."""
    use_u = math.prod(L["in"]) <= math.prod(L["out"])
    g = (lambda v: _linear(L, v, w)) if use_u else (lambda v: _adjoint(L, v, w))
    gt = (lambda v: _adjoint(L, v, w)) if use_u else (lambda v: _linear(L, v, w))
    gx = g(u.detach())
    sigma = torch.linalg.vector_norm(gx)
    with torch.no_grad():
        new = gt(gx / (sigma + SN_EPS))
        new = new / (torch.linalg.vector_norm(new) + SN_EPS)
    return sigma, new


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "linear":
        return x
    if act == "relu":
        return F.relu(x)
    if act == "lrelu":
        return F.leaky_relu(x, LRELU_SLOPE)
    if act == "tanh":
        return torch.tanh(x)
    raise ValueError(f"activation {act} is not covered")


def run_net(arch: dict, net: str, leaves: Dict[str, torch.Tensor], x: torch.Tensor,
            train: bool, precision: str = "float32") -> Tuple[torch.Tensor, Dict]:
    """(output, new state leaves): the new SN vectors, and in train mode
    the new BN moving statistics."""
    new: Dict[str, torch.Tensor] = {}
    for L in layers(arch, net):
        n = L["name"]
        w = leaves[f"{n}/kernel/kernel"]
        if L["sn"]:
            sigma, new[f"{n}/kernel/sn_x"] = power_iteration(L, w, leaves[f"{n}/kernel/sn_x"])
            w = w * (L["act_k"] / (sigma + SN_EPS))
        if L["op"] == "d" and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        y = _linear(L, x, w, precision)
        if L["bias"]:
            b = leaves[f"{n}/bias/bias"]
            y = y + (b if y.dim() == 2 else b.view(1, -1, 1, 1))
        if L["bn"]:
            dims = (0,) if y.dim() == 2 else (0, 2, 3)
            view = (1, -1) if y.dim() == 2 else (1, -1, 1, 1)
            mm, mv = leaves[f"{n}/BN/moving_mean"], leaves[f"{n}/BN/moving_var"]
            if train:
                mean = y.mean(dim=dims)
                var = ((y - mean.view(view)) ** 2).mean(dim=dims)
                with torch.no_grad():
                    new[f"{n}/BN/moving_mean"] = BN_MOMENTUM * mm + (1 - BN_MOMENTUM) * mean
                    new[f"{n}/BN/moving_var"] = BN_MOMENTUM * mv + (1 - BN_MOMENTUM) * var
            else:
                mean, var = mm, mv
            y = (y - mean.view(view)) / torch.sqrt(var.view(view) + BN_EPS)
            y = y * leaves[f"{n}/BN/gamma"].view(view) + leaves[f"{n}/BN/beta"].view(view)
        y = _act(y, L["act"])
        if L["out_reshape"] is not None:
            y = y.reshape((y.shape[0],) + tuple(L["out_reshape"]))
        x = y
    return x, new


def generate(arch: dict, leaves: Dict[str, torch.Tensor], z: torch.Tensor,
             precision: str = "float32") -> torch.Tensor:
    """Eval-mode generation: NHWC images clipped to [-1, 1]."""
    with torch.no_grad():
        x, _ = run_net(arch, "gen", leaves, z, train=False, precision=precision)
    return x.permute(0, 2, 3, 1).clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# the repulsive loss
# ---------------------------------------------------------------------------
def kernel_means(s_gen: torch.Tensor, s_x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Off-diagonal means of exp(-|a - b|^2 / 2) over gen-gen (xx),
    gen-data (xy) and data-data (yy)."""
    b = s_gen.shape[0]
    off = ~torch.eye(b, dtype=torch.bool, device=s_gen.device)

    def mean(a, c):
        d = ((a[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        return torch.exp(-d / 2.0)[off].mean()

    return {"e_kxx": mean(s_gen, s_gen), "e_kxy": mean(s_gen, s_x), "e_kyy": mean(s_x, s_x)}


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------
def net_params(specs: Dict, net: str) -> List[str]:
    return [n for n, s in specs.items() if s["group"] == "param" and n.startswith(net + "/")]


def train_step(cfg: dict, specs: Dict, state: Dict[str, torch.Tensor], x_uint8: torch.Tensor,
               z: torch.Tensor, precision: str = "float32", fault: Optional[str] = None) -> Dict:
    """One step in place on ``state`` (every leaf, then ``mu/<leaf>`` and
    ``nu/<leaf>`` of each parameter, and ``count``). ``x_uint8`` is the
    NHWC data batch, ``z`` the codes. Returns the step's metrics.

    ``fault``: ``"half_batch"`` computes the step over the first half of
    the rows, the mean taken over them."""
    arch = cfg["architecture"]
    if fault == "half_batch":
        x_uint8, z = x_uint8[: x_uint8.shape[0] // 2], z[: z.shape[0] // 2]
    elif fault is not None:
        raise ValueError(f"fault {fault} is not covered")
    b = x_uint8.shape[0]
    params = {n: state[n].detach().clone().requires_grad_(True)
              for n, s in specs.items() if s["group"] == "param"}
    fixed = {n: state[n] for n, s in specs.items() if s["group"] != "param"}
    leaves = {**fixed, **params}
    x = (x_uint8.to(torch.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)
    gen_x, gen_new = run_net(arch, "gen", leaves, z, train=True, precision=precision)
    scores, dis_new = run_net(arch, "dis", leaves, torch.cat([x, gen_x]), train=True,
                              precision=precision)
    s_x, s_gen = scores[:b], scores[b:]
    e = kernel_means(s_gen, s_x)
    w0, w1 = cfg["repulsive_weights"]
    loss_gen = e["e_kxx"] + e["e_kyy"] - 2.0 * e["e_kxy"]
    loss_dis = w0 * e["e_kxy"] - e["e_kxx"] - w1 * e["e_kyy"]
    names = {net: net_params(specs, net) for net in ("dis", "gen")}
    g_dis = torch.autograd.grad(loss_dis, [params[n] for n in names["dis"]], retain_graph=True)
    g_gen = torch.autograd.grad(loss_gen, [params[n] for n in names["gen"]])
    grads = dict(zip(names["dis"] + names["gen"], list(g_dis) + list(g_gen)))
    lrs = {"dis": cfg["lr_dis"], "gen": cfg["lr_gen"]}
    b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["eps"]
    with torch.no_grad():
        for net in ("dis", "gen"):
            t = float(state[f"count/{net}"]) + 1.0
            state[f"count/{net}"] = torch.tensor(t)
            for n in names[net]:
                g = grads[n]
                state[f"mu/{n}"] = b1 * state[f"mu/{n}"] + (1 - b1) * g
                state[f"nu/{n}"] = b2 * state[f"nu/{n}"] + (1 - b2) * g * g
                mu_hat = state[f"mu/{n}"] / (1 - b1 ** t)
                nu_hat = state[f"nu/{n}"] / (1 - b2 ** t)
                state[n] = state[n] - lrs[net] * mu_hat / (torch.sqrt(nu_hat) + eps)
        state.update(gen_new)
        state.update(dis_new)
    norm = lambda gs: float(torch.linalg.vector_norm(torch.stack(  # noqa: E731
        [torch.linalg.vector_norm(g) for g in gs])))
    return {"loss_gen": float(loss_gen.detach()), "loss_dis": float(loss_dis.detach()),
            **{k: float(v.detach()) for k, v in e.items()},
            "grad_norm_dis": norm(g_dis), "grad_norm_gen": norm(g_gen),
            "x_gen_abs_mean": float(gen_x.detach().abs().mean())}


def init_optimizer_state(state: Dict[str, torch.Tensor], specs: Dict) -> None:
    """Adam's zero slots and counts, in place."""
    for n, s in specs.items():
        if s["group"] == "param":
            state[f"mu/{n}"] = torch.zeros_like(state[n])
            state[f"nu/{n}"] = torch.zeros_like(state[n])
    state["count/dis"] = torch.tensor(0.0)
    state["count/gen"] = torch.tensor(0.0)
