"""Host seconds per training call spent bringing the window back up
(``Agent.train_device_data``, ``train/step.py`` ``StepGraphs``): the
program's spans ``agent.upload`` (the dataset's copy to the card),
``graphs.warm_up`` (the eager first window) and ``graphs.capture``, per
``agent.call``. The program records spans only under the profiler, which
runs around the traced call alone, so this is that call's re-warm. Reads
nothing without a traced stretch of steps, or where the program records
no call."""

from benchmark import program_spans

PARTS = ("agent.upload", "graphs.warm_up", "graphs.capture")


def read(run):
    st = run.stretch
    if st is None or st.unit != "step":
        return None
    totals = program_spans.program_totals()
    if not totals or "agent.call" not in totals:
        return None
    return sum(totals[n].seconds for n in PARTS if n in totals) / totals["agent.call"].count
