"""The numbers that decide ``correct``, worked out between the program's
outputs and the plain reference's.

Training (``train_gaps``), over the check's steps from the same
weights, rows and codes: steps 1 to 3 (``START``), then the window, the
program's call of K-step windows (the steps the program reports are each
call's last):

- ``loss_gap``: the widest absolute gap of a reported step's losses and
  kernel means (``loss_gen``, ``loss_dis``, ``e_kxx``, ``e_kxy``,
  ``e_kyy``); ``loss1_gap``: step 1's losses, relative to its
  ``loss_gen``;
- ``means1_gap``: step 1's kernel means, the forward kernel's outputs that
  the loss reads, by the widest relative gap of ``1 - e`` (the means sit
  near 1 at the start, so the gap of ``e`` itself says nothing);
- ``grad_norm_gap``, ``grad_norm1_gap``: the widest relative gap of a
  reported step's global gradient norm, either network, and at step 1;
- ``grad1_gap``, ``grad1_median_gap``: the first gradient as the
  optimiser got it, worked out from Adam's first moment after one step
  (``mu / (1 - b1)``), by the worst leaf and by the median leaf;
- ``change_gap.params``, ``.slots``, ``.sn``, ``.bn``: the change of the
  parameters, Adam's two slots, the spectral-norm vectors and the BN
  moving statistics after step 3, by the worst leaf
  (``change_median_gap.params``: the parameters' median leaf);
- ``window_change_median_gap.params``: the change of the parameters over
  the window, from each side's own state after step 3, by the median
  leaf. From the saturated start the two sides' paths part within a few
  steps, so this holds the window to moving the state as much as the
  reference does, and no closer.

Which of these a cell holds to a limit is its ``limits/<cell>.json``; the
rest are reported as observed.

A leaf's gap is the gap between the two norms, over the reference's norm
of that leaf or of the group's median leaf, whichever is larger. The gap of
two norms is of second order in errors that point every way, as rounding's
do, so the first gradient is also held by the norm of the difference
(``grad1_diff``, ``grad1_median_diff``): that is what separates a change of
precision from the program's own rounding. Parameters whose first reference
gradient is under a thousandth of the median leaf's (the score layer's
bias: MMD is shift-invariant, so Adam moves it by round-off alone) are
left out of the first gradient and of the change.

Serving (``serve_gap``): the widest absolute gap of a served pixel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import mmdgan

MEAN_KEYS = ("e_kxx", "e_kxy", "e_kyy")
LOSS_KEYS = ("loss_gen", "loss_dis") + MEAN_KEYS
NORM_KEYS = ("grad_norm_dis", "grad_norm_gen")
NEGLIGIBLE_GRADIENT = 1e-3

START = 3

# (metrics by step, from 1; Adam's first moment after step 1; the state after
# step START and after the last step, by step)
Trace = Tuple[Dict[int, dict], Dict[str, torch.Tensor], Dict[int, Dict[str, torch.Tensor]]]


def follow(cfg: dict, specs: Dict[str, dict], state0: Dict[str, torch.Tensor],
           data_x: np.ndarray, draws: Sequence[tuple], device: torch.device,
           precision: str = "float32", fault: str = None) -> Trace:
    """The reference's steps from ``state0``, one on the rows ``data_x[idx]``
    and codes ``z`` of each ``(idx, z)`` in ``draws``."""
    host = lambda st: {n: t.cpu() for n, t in st.items()}  # noqa: E731
    with mmdgan.float32_exact():
        state = {n: t.to(device).float().clone() for n, t in state0.items()}
        mmdgan.init_optimizer_state(state, specs)
        steps, mu1, states = {}, None, {}
        for i, (idx, z) in enumerate(draws, start=1):
            x = torch.from_numpy(np.ascontiguousarray(data_x[idx])).to(device)
            steps[i] = mmdgan.train_step(cfg, specs, state, x, z.to(device), precision, fault)
            if i == 1:
                mu1 = {n: state[f"mu/{n}"].cpu() for n, s in specs.items()
                       if s["group"] == "param"}
            if i == START:
                states[i] = host(state)
        states[len(draws)] = host(state)
    return steps, mu1, states


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              names: Sequence[str], diff: bool = False, floor: bool = True) -> List[float]:
    """Per leaf of ``names``: |‖program‖ - ‖reference‖| (with ``diff``,
    ‖program - reference‖) over ‖reference‖, or over the median leaf's
    ‖reference‖ where that is larger and ``floor`` is set."""
    ref = {n: _norm(reference[n]) for n in names}
    median = float(np.median(list(ref.values()))) if floor and names else 0.0
    return [(_norm(program[n] - reference[n]) if diff else abs(_norm(program[n]) - ref[n]))
            / max(ref[n], median, 1e-30) for n in names]


def worst_leaf(program, reference, names, diff: bool = False) -> float:
    return max(leaf_gaps(program, reference, names, diff), default=0.0)


def median_leaf(program, reference, names, diff: bool = False) -> float:
    return float(np.median(leaf_gaps(program, reference, names, diff, floor=False)))


def train_gaps(cfg: dict, specs: Dict[str, dict], state0: Dict[str, torch.Tensor],
               program: Trace, reference: Trace) -> Dict[str, float]:
    p_steps, p_mu1, p_states = program
    r_steps, r_mu1, r_states = reference
    end = max(r_states)
    p3, r3 = p_states[START], r_states[START]
    pairs = [(p_steps[i], r_steps[i]) for i in sorted(p_steps)]
    b1 = cfg["beta1"]
    state0 = {n: t.cpu() for n, t in state0.items()}
    params = [n for n, s in specs.items() if s["group"] == "param"]
    g1_ref = {n: r_mu1[n] / (1 - b1) for n in params}
    g1_prog = {n: p_mu1[n] / (1 - b1) for n in params}
    median = float(np.median([_norm(g1_ref[n]) for n in params]))
    kept = [n for n in params if _norm(g1_ref[n]) >= NEGLIGIBLE_GRADIENT * median]
    delta = lambda st, names, base=state0: {n: st[n] - base[n] for n in names}  # noqa: E731
    group = lambda g: [n for n, s in specs.items() if s["group"] == g]  # noqa: E731
    slots = {f"{slot}/{n}" for slot in ("mu", "nu") for n in kept}
    p1, r1 = p_steps[1], r_steps[1]
    return {
        "loss_gap": max(abs(float(p[k]) - r[k]) for p, r in pairs for k in LOSS_KEYS),
        "loss1_gap": max(abs(float(p1[k]) - r1[k]) for k in ("loss_gen", "loss_dis"))
        / abs(r1["loss_gen"]),
        "means1_gap": max(abs(float(p1[k]) - r1[k]) / max(1.0 - r1[k], 1e-30)
                          for k in MEAN_KEYS),
        "grad_norm_gap": max(abs(float(p[k]) - r[k]) / abs(r[k])
                             for p, r in pairs for k in NORM_KEYS),
        "grad_norm1_gap": max(abs(float(p1[k]) - r1[k]) / abs(r1[k]) for k in NORM_KEYS),
        "grad1_gap": worst_leaf(g1_prog, g1_ref, kept),
        "grad1_median_gap": median_leaf(g1_prog, g1_ref, kept),
        "grad1_diff": worst_leaf(g1_prog, g1_ref, kept, diff=True),
        "grad1_median_diff": median_leaf(g1_prog, g1_ref, kept, diff=True),
        "change_gap.params": worst_leaf(delta(p3, kept), delta(r3, kept), kept),
        "change_median_gap.params": median_leaf(delta(p3, kept), delta(r3, kept), kept),
        "change_gap.slots": max(worst_leaf(p3, r3, [s for s in slots if s.startswith(x)])
                                for x in ("mu/", "nu/")),
        "change_gap.sn": worst_leaf(delta(p3, group("sn")), delta(r3, group("sn")),
                                    group("sn")),
        "change_gap.bn": worst_leaf(delta(p3, group("bn_state")), delta(r3, group("bn_state")),
                                    group("bn_state")),
        "window_change_median_gap.params": median_leaf(delta(p_states[end], kept, p3),
                                                       delta(r_states[end], kept, r3), kept),
    }


def serve_gap(program: Sequence[np.ndarray], reference: Sequence[np.ndarray]) -> float:
    """The widest absolute gap of a served pixel over the sampled requests."""
    return max(float(np.max(np.abs(p.astype(np.float64) - r.astype(np.float64))))
               for p, r in zip(program, reference))
