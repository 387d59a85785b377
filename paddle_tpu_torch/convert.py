"""Load weights exported from the JAX package into the port's model.

``from_jax_state_dict`` takes the JAX ``LlamaForCausalLM.state_dict()``
turned into numpy arrays (``{name: np.asarray(t.numpy())}``) and builds
the port's :class:`~paddle_tpu_torch.models.LlamaForCausalLM` on
``device``.  The names are the same in both packages and every linear
weight stays in Paddle's [in, out] layout, which is what the kernels
take as ``w`` [K, N].
"""
from __future__ import annotations

import numpy as np
import torch

from .models.llama import LlamaConfig, LlamaForCausalLM


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":      # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_state_dict(named_arrays, config: LlamaConfig, device=None
                        ) -> LlamaForCausalLM:
    """The port's model with every parameter copied from
    ``named_arrays``; raises on a missing, extra or misshapen name."""
    model = LlamaForCausalLM(config, device=device, seed=None)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named_arrays))
    extra = sorted(set(named_arrays) - set(params))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            src = _to_torch(np.asarray(named_arrays[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model
