"""Optimizers of the port (``paddle_tpu/optimizer``): the ``Optimizer``
base and ``AdamW`` with the JAX package's update rule."""
from .optimizer import AdamW, Optimizer, adamw_rule

__all__ = ["AdamW", "Optimizer", "adamw_rule"]
