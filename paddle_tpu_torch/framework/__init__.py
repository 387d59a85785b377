"""The port's ``paddle_tpu.framework``: ``save`` / ``load`` of nested
state (``io``)."""
from . import io
from .io import load, save

__all__ = ["io", "load", "save"]
