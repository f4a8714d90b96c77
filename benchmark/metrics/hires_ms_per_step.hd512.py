"""Device milliseconds per train step in the full-resolution layers (maps
of 128x128 or larger: hd512's D ``l1_f512`` .. ``l4_ds`` and G ``l6_up``
.. ``l8_t256x2``), forward and backward: the program's counters
``hires.fwd_us``, ``hires.bwd_us`` and ``hires.steps``
(``mmdgan_torch/utils/spans.py`` ``StageTimer``), which the traced call's
eager first window records from CUDA event pairs around each such layer,
in its fastest step. That window is not the stretch of replays that
``device_busy_ms_per_step.train`` reads.
Reads nothing where the program has no such counters (one older than
them, or a model without such layers) or they read zero."""


def counters():
    """The program's counters, or None where the program has none."""
    try:
        from mmdgan_torch.utils import spans
    except ImportError:
        return None
    return spans.counters()


def ms_per_step(c):
    if not c:
        return None
    steps, us = c.get("hires.steps", 0), c.get("hires.fwd_us", 0) + c.get("hires.bwd_us", 0)
    if steps <= 0 or us <= 0:
        return None
    return us / 1e3 / steps


def read(run):
    return ms_per_step(counters())
