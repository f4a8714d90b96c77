"""Entry scripts of the port (``python -m mmdgan_torch.experiments.cifar``)."""
