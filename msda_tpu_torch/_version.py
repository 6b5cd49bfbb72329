"""Version of the PyTorch / CUDA port (``msda_tpu_torch``).

It tracks the version of the JAX reference package it is held against
(``msda_tpu/_version.py``).
"""

__version__ = "0.4.0"
