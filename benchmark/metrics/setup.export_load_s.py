"""Seconds of the serving restart in set-up: ``export_generator`` (trace
and save the program) plus ``load_exported`` (load it and move it to the
card), ``utils/export.py``. The benchmark's own spans."""


def read(run):
    spans = run.spans.seconds
    if "setup.export" not in spans or "setup.load" not in spans:
        return None
    return spans["setup.export"] + spans["setup.load"]
