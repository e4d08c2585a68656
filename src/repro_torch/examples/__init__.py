"""Twins of the JAX package's example scripts (``examples/quickstart.py``,
``examples/diy_slim.py``), run as ``python -m repro_torch.examples.<name>``."""
