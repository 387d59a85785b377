"""Load weights exported from the JAX package into the port's models.

``from_jax_state_dict`` takes the JAX ``LlamaForCausalLM.state_dict()``
turned into numpy arrays (``{name: np.asarray(t.numpy())}``) and builds
the port's :class:`~paddle_tpu_torch.models.LlamaForCausalLM` on
``device``.  The names are the same in both packages and every linear
weight stays in Paddle's [in, out] layout, which is what the kernels
take as ``w`` [K, N].

``bert_from_jax`` does the same for the JAX ``BertForPretraining``,
whose names the port's BERT shares too; its ``Linear`` layers keep
PyTorch's [out, in] weight, so every one of them is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.bert import BertConfig, BertForPretraining
from .models.llama import LlamaConfig, LlamaForCausalLM
from .nn.layer import Linear


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":      # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _load(model, named_arrays, transposed=frozenset()):
    """Copy every parameter of ``model`` from ``named_arrays`` (those
    named in ``transposed`` transposed); raises on a missing, extra or
    misshapen name."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named_arrays))
    extra = sorted(set(named_arrays) - set(params))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            src = _to_torch(np.asarray(named_arrays[name]))
            if name in transposed:
                src = src.t()
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def from_jax_state_dict(named_arrays, config: LlamaConfig, device=None
                        ) -> LlamaForCausalLM:
    """The port's Llama with every parameter copied from ``named_arrays``."""
    return _load(LlamaForCausalLM(config, device=device, seed=None),
                 named_arrays)


def bert_from_jax(named_arrays, config: BertConfig, device=None,
                  generator=None) -> BertForPretraining:
    """The port's BERT with every parameter copied from ``named_arrays``,
    each ``Linear`` weight transposed from [in, out] to [out, in];
    ``generator`` draws its dropout masks."""
    model = BertForPretraining(config, device=device, seed=None,
                               generator=generator)
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, Linear)}
    return _load(model, named_arrays, linear)
