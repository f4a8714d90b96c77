"""The card's idle share of the traced stretch of replayed K-step
windows, in percent: 100 (1 - union of activity / the stretch's length).
The stretch runs from the first kernel of one replay to the first kernel
of the replay after its last, so every gap between windows (the host's
guard syncs among them) is inside it."""


def read(run):
    st = run.stretch
    if st is None or st.unit != "step":
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
