"""The GAN loss catalogue (``mmdgan_tpu/ops/losses.py``): every branch of the
dispatcher under every alias.

``GANLoss.apply(score_gen, score_data, loss_type, batch_size=...)`` returns
``(loss_gen, loss_dis, new_state, aux)`` like the JAX dispatcher, with the
same ``aux`` keys: kernel means (per sigma ``sigma_{i}/``, per alpha
``alpha_{i}/``, ``mix/``, ``rn/``, ``gn/``, ``bounded/``), ``beta`` and
``omega`` of the rand_* family, the loss state (``state/``), the penalty
and scale, and with ``summary_histograms`` fixed-bin ``hist/*`` counts.

Random draws (omega, the mix coin's uniforms, the instance-noise normals)
come from the ``generator`` passed in: ``draw`` makes them in a fixed
order, and ``apply(draws=...)`` takes them given instead. Nothing here
asks the host what a tensor holds, so every loss runs inside a CUDA graph.

``use_fused_kernel`` (the counterpart of JAX's ``use_pallas``) routes the
repulsive family (rep, rmb and their aliases, penalised and scaled) through
``cuda_mmd``'s kernel means: on CUDA tensors the hand-written kernels, on
CPU tensors their plain versions; the penalty or the scale applies after
the kernel. It defaults to True. The bounded loss takes it only for
repulsive weights (w0 <= 0, w1 <= 0), which is all the kernel computes;
other weights run the plain path, as JAX's default does. The aux keys are
the same with it on or off.

Like the JAX dispatcher, ``fixed_g_gp`` and ``fixed_t_gp`` raise here,
though ``SNGan`` computes their penalty.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mmdgan_torch.ops.cuda_mmd import (
    MEAN_KEYS,
    repulsive_mmd_g_bounded_fused,
    repulsive_mmd_g_fused,
)
from mmdgan_torch.ops.distance import get_squared_dist, slice_pairwise_distance
from mmdgan_torch.ops.kernels import (
    cramer,
    mixture_mmd_g,
    mixture_mmd_t,
    mmd_g,
    mmd_g_bounded,
    rand_mmd_g_xn,
    rand_mmd_g_xy,
    rand_mmd_g_xy_bounded,
)

# fixed bins of the hist/* aux keys; the writer rebuilds the edges from these
HIST_NBINS = 64
HIST_RANGES = {
    "hist/d_xx": (0.0, 16.0),
    "hist/d_xy": (0.0, 16.0),
    "hist/d_yy": (0.0, 16.0),
    "hist/score_gen": (-8.0, 8.0),
    "hist/score_x": (-8.0, 8.0),
}

REPULSIVE = ("rep", "rep_mmd_g", "rep_gp", "rep_ds")
REPULSIVE_BOUNDED = ("rmb", "rep_b", "rep_mmd_b", "rmb_gp", "rmb_ds")
MMD_LIKE = frozenset({
    "fixed_g", "mmd_g", "fixed_t", "mmd_t", "mmd_g_mix", "fixed_g_mix",
    "rand_g", "rand_g_mix", "sym_rg_mix", "instance_noise", "ins_noise",
    "sym_rg", "rgb", "mgb", "sgm", "sym_rand_g", "cramer",
    *REPULSIVE, *REPULSIVE_BOUNDED,
})
NEEDS_D = frozenset({"rand_g", "rand_g_mix", "sym_rg_mix", "sym_rg", "sym_rand_g",
                     "instance_noise", "ins_noise"})
PENALISED = frozenset({"rep_gp", "rmb_gp", "wasserstein"})
SCALED = frozenset({"rep_ds", "rmb_ds"})
# the branches that add a given dis_penalty to loss_dis
# (losses.py:173,195-196,210-211,221-222,241-242,262-263,454)
TAKES_PENALTY = frozenset({"fixed_g", "mmd_g", "mgb", "fixed_t", "mmd_t", "cramer",
                           "wasserstein", *REPULSIVE, *REPULSIVE_BOUNDED})
# the draws: the instance-noise normals, omega, the coin's uniforms
DRAWS_NOISE = frozenset({"instance_noise", "ins_noise"})
DRAWS_OMEGA = NEEDS_D | {"rgb"}
DRAWS_COIN = frozenset({"mmd_g_mix", "fixed_g_mix", "sgm", "rand_g_mix", "sym_rg_mix"})
STATEFUL = DRAWS_COIN | DRAWS_NOISE
# every name the dispatcher takes
LOSS_TYPES = ("logistic", "", "hinge", "wasserstein", "test", *sorted(MMD_LIKE))


def fixed_bin_histogram(x: torch.Tensor, lo: float, hi: float,
                        nbins: int = HIST_NBINS) -> torch.Tensor:
    """float32 counts [nbins] over a static range, the first and last bins
    taking what falls outside. A one-hot sum: a static shape inside a
    capture and deterministic, which CUDA's weighted bincount is not."""
    idx = torch.clamp(((x.detach().reshape(-1) - lo) * (nbins / (hi - lo))).to(torch.int32),
                      0, nbins - 1)
    bins = torch.arange(nbins, dtype=torch.int32, device=x.device)
    return (idx[:, None] == bins[None, :]).to(torch.float32).sum(0)


@dataclasses.dataclass
class LossState:
    """Persistent loss state, updated once per train step: the moving
    average of the generator loss, the mixing probability of the coin, the
    instance-noise sigma."""

    loss_average: torch.Tensor
    mix_prob: torch.Tensor
    ins_sigma: torch.Tensor

    @staticmethod
    def init(device="cpu") -> "LossState":
        z = lambda: torch.zeros((), dtype=torch.float32, device=device)
        return LossState(loss_average=z(), mix_prob=z(), ins_sigma=z())


def _get_mix_coin(uni: torch.Tensor, loss: torch.Tensor, loss_threshold: float,
                  state: LossState, loss_average_update: float = 0.01,
                  mix_prob_update: float = 0.01) -> Tuple[torch.Tensor, LossState]:
    """Mix indices from the uniforms ``uni`` [B] and the updated state. The
    reads use the state before the update (``losses.py:108-129``)."""
    mix_indices = uni > state.mix_prob   # True keeps the original group
    new_avg = (1.0 - loss_average_update) * state.loss_average + loss_average_update * loss
    new_prob = torch.clamp(
        state.mix_prob + mix_prob_update * (state.loss_average - loss_threshold), 0.0, 0.5)
    return mix_indices, dataclasses.replace(state, loss_average=new_avg, mix_prob=new_prob)


@dataclasses.dataclass
class GANLoss:
    """Hyper-parameters and the dispatcher."""

    sigma: Sequence[float] = (1.0, float(np.sqrt(2.0)), 2.0, float(np.sqrt(8.0)), 4.0)
    alpha: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0)
    beta: float = 2.0
    # a pair is the range omega is drawn from, a scalar a fixed omega
    omega_range: Tuple[float, float] = (0.05, 0.85)
    ref_normal: float = 1.0
    # weights for e_kxy and -e_kyy; w[0]-w[1] == 1; k_yy is the REAL data kernel
    repulsive_weights: Sequence[float] = (0.0, -1.0)
    mix_threshold: float = 0.2
    use_fused_kernel: bool = True
    summary_histograms: bool = False

    def __post_init__(self):
        # The route of the repulsive family, decided once on Python floats:
        # 'rep' fits the kernel means for any weights with w0 - w1 = 1; the
        # bounded kernel implements the repulsive direction only (w0 <= 0,
        # w1 <= 0), so other weights take the plain path, as in JAX.
        w0, w1 = (float(w) for w in self.repulsive_weights)
        self.fused_rep = bool(self.use_fused_kernel)
        self.fused_rmb = bool(self.use_fused_kernel) and w0 <= 0 and w1 <= 0

    # ----- random draws ---------------------------------------------------
    def draw(self, loss_type: str, score_gen: torch.Tensor,
             generator: Optional[torch.Generator]) -> Dict[str, object]:
        """The loss's random draws, in a fixed order, as the keywords of
        :meth:`apply`: the instance-noise normals (gen, then data), omega,
        the coin's uniforms. Losses that draw nothing return {}. A mesh
        step passes the scores gathered over its ranks, so every rank draws
        the same numbers from its replica of the generator."""
        dev = score_gen.device
        out: Dict[str, object] = {}
        if loss_type in DRAWS_NOISE:
            out["noise"] = tuple(torch.randn(score_gen.shape, generator=generator, device=dev)
                                 for _ in range(2))
        if loss_type in DRAWS_OMEGA and isinstance(self.omega_range, (list, tuple)):
            lo, hi = self.omega_range
            out["omega"] = lo + (hi - lo) * torch.rand((), generator=generator, device=dev)
        if loss_type in DRAWS_COIN:
            out["coin"] = torch.rand(score_gen.shape[0], generator=generator, device=dev)
        return out

    def _omega(self, omega, like: torch.Tensor):
        if omega is not None:
            return omega
        if isinstance(self.omega_range, (list, tuple)):
            raise ValueError("GANLoss: omega is drawn from a range; pass it (see draw)")
        return torch.as_tensor(self.omega_range, dtype=torch.float32, device=like.device)

    # ----- simple adversarial losses -------------------------------------
    @staticmethod
    def _logistic(s_gen, s_x):
        sp = torch.nn.functional.softplus
        return torch.mean(sp(-s_gen)), torch.mean(sp(s_gen) + sp(-s_x))

    @staticmethod
    def _hinge(s_gen, s_x):
        loss_dis = torch.mean(torch.relu(1.0 + s_gen)) + torch.mean(torch.relu(1.0 - s_x))
        return torch.mean(-s_gen), loss_dis

    # ----- mmd losses -----------------------------------------------------
    def _stash_dist_hist(self, aux, d_gg, d_gd, d_dd):
        # x = generated, y = real in the reference's kernel naming
        if self.summary_histograms:
            for key, dist in (("hist/d_xx", d_gg), ("hist/d_xy", d_gd), ("hist/d_yy", d_dd)):
                aux[key] = fixed_bin_histogram(dist, *HIST_RANGES[key])

    def _dists(self, s_gen, s_x, aux):
        d_gg, d_gd, d_dd = get_squared_dist(s_gen, s_x, mode="xxxyyy")
        self._stash_dist_hist(aux, d_gg, d_gd, d_dd)
        return d_gg, d_gd, d_dd

    def _pair_dists(self, s_gen, s_x, batch_size, aux):
        """The [2B, 2B] distances of concat(gen, data) and their blocks."""
        pair_dist = get_squared_dist(torch.cat([s_gen, s_x], dim=0))
        d_gg, d_gd, d_dd = slice_pairwise_distance(pair_dist, batch_size=batch_size)
        self._stash_dist_hist(aux, d_gg, d_gd, d_dd)
        return pair_dist, d_gg, d_gd, d_dd

    def _mmd_g_bound(self, s_gen, s_x, batch_size, aux):
        # 'mgb'
        dists = self._dists(s_gen, s_x, aux)
        loss_gen, k_aux = mmd_g(*dists, batch_size, sigma=1.0, with_aux=True)
        mmd_b, b_aux = mmd_g(*dists, batch_size, sigma=1.0, upper_bound=4, lower_bound=0.25,
                             with_aux=True)
        aux.update(k_aux)
        aux.update({f"bounded/{k}": v for k, v in b_aux.items()})
        return loss_gen, -mmd_b

    def _repulsive(self, s_gen, s_x, batch_size, aux, bounded: bool):
        """'rep' and 'rmb' (the bounded kernel), through the kernel means
        or the plain distance + kernel path (``__post_init__`` picks)."""
        if self.fused_rmb if bounded else self.fused_rep:
            fused = repulsive_mmd_g_bounded_fused if bounded else repulsive_mmd_g_fused
            loss_gen, loss_dis, e = fused(s_gen, s_x, sigma=1.0,
                                          repulsive_weights=tuple(self.repulsive_weights))
            aux.update(zip(MEAN_KEYS if bounded else MEAN_KEYS[:3], e.unbind(0)))
            if self.summary_histograms:
                with torch.no_grad():
                    self._dists(s_gen, s_x, aux)
            return loss_gen, loss_dis
        dists = self._dists(s_gen, s_x, aux)
        if bounded:
            loss_gen, loss_dis, k_aux = mmd_g_bounded(
                *dists, batch_size, sigma=1.0, lower_bound=0.25, upper_bound=4.0,
                custom_weights=self.repulsive_weights, with_aux=True)
        else:
            loss_gen, loss_dis, k_aux = mmd_g(
                *dists, batch_size, sigma=1.0, custom_weights=self.repulsive_weights,
                with_aux=True)
        aux.update(k_aux)
        return loss_gen, loss_dis

    # ----- mix-coin losses ------------------------------------------------
    def _mmd_g_mix(self, s_gen, s_x, batch_size, coin, state, single_sigma: bool, aux):
        pair_dist, *dists = self._pair_dists(s_gen, s_x, batch_size, aux)

        def mmd(ds):
            if single_sigma:
                return mmd_g(*ds, batch_size, sigma=1.0, with_aux=True)
            return mixture_mmd_g(*ds, batch_size, sigma=self.sigma, with_aux=True)

        loss_gen, k_aux = mmd(dists)
        aux.update(k_aux)
        mix_indices, state = _get_mix_coin(coin, loss_gen, self.mix_threshold, state)
        loss_mix, m_aux = mmd(slice_pairwise_distance(pair_dist, indices=mix_indices))
        aux.update({f"mix/{k}": v for k, v in m_aux.items()})
        return loss_gen, -loss_mix, state

    def _rand_g(self, s_gen, s_x, batch_size, d, omega, aux):
        d_gg, d_gd, d_dd = self._dists(s_gen, s_x, aux)
        loss_gr, gr_aux = rand_mmd_g_xy(d_gg, d_gd, d_dd, batch_size, omega=omega, max_iter=3,
                                        with_aux=True)
        loss_rn, rn_aux = rand_mmd_g_xn(s_x, self.ref_normal, batch_size, d, dist_xx=d_dd,
                                        omega=omega, max_iter=3, with_aux=True)
        aux["omega"] = omega
        aux.update(gr_aux)
        aux.update({f"rn/{k}": v for k, v in rn_aux.items()})
        return loss_gr, loss_rn - loss_gr

    def _rand_g_bounded(self, s_gen, s_x, batch_size, omega, aux):
        # 'rgb'
        dists = self._dists(s_gen, s_x, aux)
        loss_gr, loss_gr_b, k_aux = rand_mmd_g_xy_bounded(*dists, batch_size, omega=omega,
                                                          max_iter=3, with_aux=True)
        aux["omega"] = omega
        aux.update(k_aux)
        return loss_gr, -loss_gr_b

    def _rand_g_mix(self, s_gen, s_x, batch_size, d, omega, coin, state, symmetric: bool, aux):
        pair_dist, d_gg, d_gd, d_dd = self._pair_dists(s_gen, s_x, batch_size, aux)
        loss_gr, gr_aux = rand_mmd_g_xy(d_gg, d_gd, d_dd, batch_size, omega=omega, max_iter=3,
                                        with_aux=True)
        loss_gn, gn_aux = rand_mmd_g_xn(s_gen, self.ref_normal, batch_size, d, dist_xx=d_gg,
                                        omega=omega, max_iter=3, with_aux=True)
        loss_rn, rn_aux = rand_mmd_g_xn(s_x, self.ref_normal, batch_size, d, dist_xx=d_dd,
                                        omega=omega, max_iter=3, with_aux=True)
        mix_indices, state = _get_mix_coin(coin, loss_gr, self.mix_threshold, state)
        loss_gr_mix, mix_aux = rand_mmd_g_xy(
            *slice_pairwise_distance(pair_dist, indices=mix_indices), batch_size, omega=omega,
            max_iter=3, with_aux=True)
        aux["omega"] = omega
        aux.update(gr_aux)
        aux.update({f"gn/{k}": v for k, v in gn_aux.items()})
        aux.update({f"rn/{k}": v for k, v in rn_aux.items()})
        aux.update({f"mix/{k}": v for k, v in mix_aux.items()})
        if symmetric:   # 'sym_rg_mix'
            return loss_gr + loss_gn, loss_rn - loss_gr_mix - loss_gn, state
        return loss_gr, loss_rn - loss_gr_mix, state

    def _sym_rand_g(self, s_gen, s_x, batch_size, d, omega, aux):
        # 'sym_rg'
        _, d_gg, d_gd, d_dd = self._pair_dists(s_gen, s_x, batch_size, aux)
        loss_gr, gr_aux = rand_mmd_g_xy(d_gg, d_gd, d_dd, batch_size, omega=omega, max_iter=3,
                                        with_aux=True)
        loss_gn, gn_aux = rand_mmd_g_xn(s_gen, self.ref_normal, batch_size, d, y_mu=-0.5,
                                        dist_xx=d_gg, omega=omega, max_iter=3, with_aux=True)
        loss_rn, rn_aux = rand_mmd_g_xn(s_x, self.ref_normal, batch_size, d, y_mu=0.5,
                                        dist_xx=d_dd, omega=omega, max_iter=3, with_aux=True)
        aux["omega"] = omega
        aux.update(gr_aux)
        aux.update({f"gn/{k}": v for k, v in gn_aux.items()})
        aux.update({f"rn/{k}": v for k, v in rn_aux.items()})
        return loss_gr, 0.5 * (loss_rn + loss_gn) - loss_gr

    def _instance_noise(self, s_gen, s_x, batch_size, d, omega, noise, state, aux):
        """N(0, log(1 + sigma)) noise on the scores, rand_g on them, then
        sigma moved by the loss's moving average."""
        stddev = torch.log(state.ins_sigma + 1.0)
        s_gen = s_gen + stddev * noise[0]
        s_x = s_x + stddev * noise[1]
        loss_gen, loss_dis = self._rand_g(s_gen, s_x, batch_size, d, omega, aux)
        aux["ins_stddev"] = stddev
        new_avg = 0.99 * state.loss_average + 0.01 * loss_gen
        new_sigma = torch.clamp(
            state.ins_sigma + 0.001 * (state.loss_average - self.mix_threshold), 0.0, 1.7183)
        return loss_gen, loss_dis, dataclasses.replace(state, loss_average=new_avg,
                                                       ins_sigma=new_sigma)

    # ----- dispatcher -----------------------------------------------------
    def apply(
        self,
        score_gen: torch.Tensor,
        score_data: torch.Tensor,
        loss_type: str = "logistic",
        batch_size: Optional[int] = None,
        d: Optional[int] = None,
        dis_penalty: Optional[torch.Tensor] = None,
        dis_scale: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        state: Optional[LossState] = None,
        draws: Optional[Dict[str, object]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, LossState, Dict[str, torch.Tensor]]:
        """Returns (loss_gen, loss_dis, new_state, aux). ``draws`` (keys
        ``omega``, ``coin``: [B] uniforms, ``noise``: normals shaped like
        the two score matrices) replaces what :meth:`draw` would take from
        ``generator``."""
        if state is None:
            state = LossState.init(score_gen.device)
        if loss_type in MMD_LIKE:
            assert batch_size is not None, "GANLoss: batch_size must be provided"
            assert score_gen.shape[0] == score_data.shape[0] == batch_size, (
                f"GANLoss: score shapes {score_gen.shape[0]}/{score_data.shape[0]} "
                f"do not match batch_size {batch_size}")
        if loss_type in NEEDS_D:
            assert d is not None, "GANLoss: d must be provided"
        if loss_type in PENALISED:
            assert dis_penalty is not None, "Discriminator penalty must be provided."
        if loss_type in SCALED:
            assert dis_scale is not None, "Discriminator loss scale must be provided."
        if draws is None:
            draws = self.draw(loss_type, score_gen, generator)
        omega, coin, noise = (draws.get(k) for k in ("omega", "coin", "noise"))

        aux: Dict[str, torch.Tensor] = {}
        s_gen, s_x, b = score_gen, score_data, batch_size
        if loss_type in {"logistic", ""}:
            lg, ld = self._logistic(s_gen, s_x)
        elif loss_type == "hinge":
            lg, ld = self._hinge(s_gen, s_x)
        elif loss_type == "wasserstein":
            lg = torch.mean(s_x) - torch.mean(s_gen)
            ld = -lg
        elif loss_type in {"fixed_g", "mmd_g"}:
            lg, k_aux = mixture_mmd_g(*self._dists(s_gen, s_x, aux), b, sigma=self.sigma,
                                      with_aux=True)
            aux.update(k_aux)
            ld = -lg
        elif loss_type == "mgb":
            lg, ld = self._mmd_g_bound(s_gen, s_x, b, aux)
        elif loss_type in {"fixed_t", "mmd_t"}:
            lg, k_aux = mixture_mmd_t(*self._dists(s_gen, s_x, aux), b, alpha=self.alpha,
                                      beta=self.beta, with_aux=True)
            aux.update(k_aux)
            ld = -lg
        elif loss_type == "cramer":
            lg, k_aux = cramer(*self._dists(s_gen, s_x, aux), b, with_aux=True)
            aux.update(k_aux)
            ld = -lg
        elif loss_type in {"mmd_g_mix", "fixed_g_mix", "sgm"}:
            lg, ld, state = self._mmd_g_mix(s_gen, s_x, b, coin, state,
                                            single_sigma=loss_type == "sgm", aux=aux)
        elif loss_type == "rand_g":
            lg, ld = self._rand_g(s_gen, s_x, b, d, self._omega(omega, s_gen), aux)
        elif loss_type == "rgb":
            lg, ld = self._rand_g_bounded(s_gen, s_x, b, self._omega(omega, s_gen), aux)
        elif loss_type in {"rand_g_mix", "sym_rg_mix"}:
            lg, ld, state = self._rand_g_mix(s_gen, s_x, b, d, self._omega(omega, s_gen), coin,
                                             state, symmetric=loss_type == "sym_rg_mix",
                                             aux=aux)
        elif loss_type in {"sym_rg", "sym_rand_g"}:
            lg, ld = self._sym_rand_g(s_gen, s_x, b, d, self._omega(omega, s_gen), aux)
        elif loss_type in {"instance_noise", "ins_noise"}:
            lg, ld, state = self._instance_noise(s_gen, s_x, b, d, self._omega(omega, s_gen),
                                                 noise, state, aux)
        elif loss_type in REPULSIVE or loss_type in REPULSIVE_BOUNDED:
            bounded = loss_type in REPULSIVE_BOUNDED
            lg, ld = self._repulsive(s_gen, s_x, b, aux, bounded)
        elif loss_type == "test":
            lg = torch.zeros((), device=s_gen.device)
            ld = torch.zeros((), device=s_gen.device)
        else:
            raise NotImplementedError(f"loss {loss_type} not implemented.")

        # a given penalty joins loss_dis of the losses in TAKES_PENALTY
        # only (the others report it); the scale is asymmetric: rep_ds
        # scales (loss_dis - 1), rmb_ds loss_dis (losses.py:243-244,264-265)
        if dis_penalty is not None and loss_type in TAKES_PENALTY:
            ld = ld + dis_penalty
        if dis_scale is not None:
            if loss_type in REPULSIVE:
                ld = (ld - 1.0) * dis_scale
            elif loss_type in REPULSIVE_BOUNDED:
                ld = ld * dis_scale

        if loss_type in STATEFUL:
            aux["state/loss_average"] = state.loss_average
            aux["state/mix_prob"] = state.mix_prob
            aux["state/ins_sigma"] = state.ins_sigma
        if dis_penalty is not None:
            aux["dis_penalty"] = torch.as_tensor(dis_penalty)
        if dis_scale is not None:
            aux["dis_scale"] = torch.as_tensor(dis_scale)
        if self.summary_histograms:
            aux["hist/score_gen"] = fixed_bin_histogram(s_gen, *HIST_RANGES["hist/score_gen"])
            aux["hist/score_x"] = fixed_bin_histogram(s_x, *HIST_RANGES["hist/score_x"])
        return lg, ld, state, aux

    def __call__(self, *args, **kwargs):
        return self.apply(*args, **kwargs)


def gan_loss(score_gen, score_data, loss_type="logistic", **kwargs):
    """Convenience wrapper constructing a default :class:`GANLoss`: the
    hyper-parameter keywords (sigma, alpha, beta, omega, ref_normal,
    rep_weights, mix_threshold, use_fused_kernel, summary_histograms)
    configure it, the rest go to :meth:`GANLoss.apply`."""
    names = {"sigma": "sigma", "alpha": "alpha", "beta": "beta", "omega": "omega_range",
             "ref_normal": "ref_normal", "rep_weights": "repulsive_weights",
             "mix_threshold": "mix_threshold", "use_fused_kernel": "use_fused_kernel",
             "summary_histograms": "summary_histograms"}
    hp = {field: kwargs.pop(key) for key, field in names.items() if key in kwargs}
    return GANLoss(**hp).apply(score_gen, score_data, loss_type, **kwargs)
