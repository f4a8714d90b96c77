"""Device idle milliseconds per train step while the training loop
waited for its next batch: the idle gaps of the traced stretch inside the
program's ``agent.feed_wait`` spans (each ``next()`` on the prefetcher
in ``Agent.train``), per step of the stretch. The wait of the loop, not
of the reader's thread."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("agent.feed_wait",), "step")
