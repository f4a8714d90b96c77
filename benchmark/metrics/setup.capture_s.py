"""Seconds of the first, warming call of the train window in set-up: the
dataset upload, the window's eager warm-up on a side stream, its CUDA
graph capture and the first replays (``train/step.py`` ``StepGraphs``
through ``Agent.train_device_data``). The benchmark's own span."""


def read(run):
    return run.spans.seconds.get("setup.capture")
