"""The card's idle share of the traced stretch of a client's calls, in
percent: 100 (1 - union of activity / the stretch's host window). The
window is the host's annotation around the calls, so idle at its edges
counts."""


def read(run):
    st = run.stretch
    if st is None or st.unit != "call":
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
