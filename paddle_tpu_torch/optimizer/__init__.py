"""Optimizers of the port (``paddle_tpu/optimizer``): the ``Optimizer``
base, the JAX package's ten optimizers with its update rules, and the
learning-rate schedulers (``lr``)."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        LarsMomentum, Momentum, Optimizer, RMSProp,
                        adamw_rule)

# the reference's name for LARS, as the JAX package aliases it
Lars = LarsMomentum

__all__ = ["SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Lamb",
           "Lars", "LarsMomentum", "Momentum", "Optimizer", "RMSProp",
           "adamw_rule", "lr"]
