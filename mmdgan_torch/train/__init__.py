"""Optimizer, TrainState and the train step."""
