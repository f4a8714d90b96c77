"""Device idle milliseconds per served call while the host dispatched the
exported generator: the idle gaps of the traced stretch of a client's
calls inside the program's ``serve.call`` spans (``utils/export.py``
``load_exported``), per call."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("serve.call",), "call")
