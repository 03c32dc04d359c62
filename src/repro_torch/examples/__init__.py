"""Runnable examples of the port, the counterparts of the JAX package's
``examples/`` (``python -m repro_torch.examples.<name>``)."""
