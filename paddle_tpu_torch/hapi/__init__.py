"""The port's ``paddle.hapi``: ``Model`` (prepare / fit / evaluate /
predict / save / load) and its callbacks."""
from . import callbacks
from .model import Model, summary

__all__ = ["Model", "callbacks", "summary"]
