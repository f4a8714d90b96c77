"""The port's command-line tools (``tools/`` of the JAX package)."""
