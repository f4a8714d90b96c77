"""Device idle milliseconds per train step while the host was in the
Agent's guards and summaries: the idle gaps of the traced stretch inside
the program's ``agent.guard`` (``Agent._check``: the sync and the copy
of the metrics to the host) and ``agent.report`` (``Agent._report``)
spans, per step of the stretch."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("agent.guard", "agent.report"), "step")
