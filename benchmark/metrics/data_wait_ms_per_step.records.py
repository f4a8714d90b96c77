"""Milliseconds per train step that the Agent's feeding thread waited on
the record reader (``data/pipeline.py``, ``data/native.py``,
``csrc/tfrec.cc``): the benchmark's iterator around the reader's batches
times each ``next()`` over the traced call, per step."""


def read(run):
    wait = run.counters.get("data_wait_s_per_step")
    return None if wait is None else 1e3 * wait
