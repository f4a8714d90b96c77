"""Initializers, ParametricOp, Layer, Net/Routine and SNGan."""
