"""Device idle milliseconds per train step while the host was launching
a window: the idle gaps of the traced stretch inside the program's
``graphs.replay`` spans (``train/step.py`` ``StepGraphs.run``), per step
of the stretch."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("graphs.replay",), "step")
