"""Device busy milliseconds per served call: the union of the card's
activity (the exported program's kernels and the copy of the images to
the host) over the traced stretch of a client's calls, per call."""


def read(run):
    st = run.stretch
    if st is None or st.unit != "call":
        return None
    return 1e3 * st.busy_s / st.units
