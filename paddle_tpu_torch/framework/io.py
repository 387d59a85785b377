"""``save`` / ``load`` of nested state (the port of
``paddle_tpu/framework/io.py``).

A state tree (dicts, lists and tuples of tensors, arrays and plain
values) is pickled with every tensor turned into a
:class:`TensorPayload`: a numpy array and the tensor's dtype.  numpy
holds no bfloat16 without ``ml_dtypes``, so a bf16 tensor is stored as
its ``uint16`` view with the tag ``"bfloat16"``; a file written here
loads where ``ml_dtypes`` is missing.  ``load`` gives CPU tensors, or
with ``return_numpy=True`` numpy arrays (a bf16 one as an ``ml_dtypes``
array, which needs that package).

:func:`to_tensor` reads any leaf of such a tree, or of one the JAX
package wrote (numpy, ``ml_dtypes`` bf16 included), as a CPU tensor.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["TensorPayload", "load", "save", "to_host", "to_tensor"]


class TensorPayload:
    """A tensor on the host: ``array`` (numpy; for bf16 its ``uint16``
    view) and ``dtype``, the tensor's dtype name."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        self.array = array
        self.dtype = dtype

    def to_tensor(self) -> torch.Tensor:
        a = np.ascontiguousarray(self.array)
        if self.dtype == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    def numpy(self) -> np.ndarray:
        if self.dtype != "bfloat16":
            return self.array
        import ml_dtypes

        return self.array.view(ml_dtypes.bfloat16)


def to_host(t: torch.Tensor):
    """A finished host copy of ``t``: a numpy array, or for bf16 a
    :class:`TensorPayload` of its ``uint16`` view.  The copy is made
    before this returns, so the caller may write ``t`` in place at
    once."""
    h = t.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        return TensorPayload(h.view(torch.int16).numpy().view(np.uint16),
                             "bfloat16")
    return h.numpy()


def to_tensor(value) -> torch.Tensor:
    """A CPU tensor of a state leaf: a tensor (as it is), a
    :class:`TensorPayload`, a numpy array (``ml_dtypes`` bf16 through its
    ``uint16`` view; shared with the tensor unless read-only or not
    contiguous) or a number."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, TensorPayload):
        return value.to_tensor()
    a = np.asarray(value)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")      # torch takes no read-only array
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_file(obj: Any):
    if isinstance(obj, torch.Tensor):
        h = to_host(obj)
        return h if isinstance(h, TensorPayload) else \
            TensorPayload(h, str(obj.dtype).removeprefix("torch."))
    if isinstance(obj, dict):
        return {k: _to_file(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_file(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_file(obj: Any, return_numpy: bool):
    if isinstance(obj, TensorPayload):
        return obj.numpy() if return_numpy else obj.to_tensor()
    if isinstance(obj, dict):
        return {k: _from_file(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_file(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path``, its tensors as :class:`TensorPayload`s
    (the parent directory is made)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_file(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """The tree :func:`save` wrote, its tensors on the CPU (numpy arrays
    with ``return_numpy``)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return _from_file(data, return_numpy)
