"""The forward kernel of the kernel means (``kernel_means_fwd``,
``csrc/kernel_means.cu``) as a share of its roofline, in percent: the
least time of the six means at the step's (B, d)
(``arith.kernel_means_bound_ms``) over the kernel's mean device time per
launch in the traced stretch. The bound counts the six means' work,
whatever implements them; with no such kernel in the stretch it reads
nothing."""

from benchmark import arith

KERNEL = "kernel_means_fwd"


def read(run):
    st = run.stretch
    if st is None or st.unit != "step":
        return None
    seconds = calls = 0
    for name, (t, n) in st.by_name().items():
        if KERNEL in name:
            seconds, calls = seconds + t, calls + n
    if not calls:
        return None
    bound_ms = arith.kernel_means_bound_ms(*arith.score_shape(run.cfg))[0]
    return 100.0 * bound_ms / (1e3 * seconds / calls)
