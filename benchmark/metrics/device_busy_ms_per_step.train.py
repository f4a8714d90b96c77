"""Device busy milliseconds per train step: the union of the card's
activity intervals over the traced stretch of replayed K-step windows,
divided by its steps (the model, loss and optimiser on the card)."""


def read(run):
    st = run.stretch
    if st is None or st.unit != "step":
        return None
    return 1e3 * st.busy_s / st.units
