"""The whole train step's share of the card's dense bf16 peak over the
traced stretch, in percent: model FLOPs per step (``arith.train_step_flops``,
from the configuration) x steps / the stretch's seconds / 989 TFLOP/s."""

from benchmark import arith


def read(run):
    st = run.stretch
    if st is None or st.unit != "step":
        return None
    flops = arith.train_step_flops(run.cfg)["total"]
    return 100.0 * flops * st.units / st.window_s / arith.PEAK_BF16_FLOP_PER_S
