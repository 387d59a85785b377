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

``load_named`` is the name-based path both use, and what a checkpoint's
``"model"`` tree (``network.state_dict()`` of either package) goes
through: every parameter and persistent buffer of the port's module is
copied from the entry of its name.  The JAX models the port has (Llama,
its MoE form, BERT) hold no persistable buffer (their RoPE tables are
non-persistable, in both packages), so their state dicts name
parameters only; a name that is neither a parameter nor a persistent
buffer of the port's module raises.

``optimizer_state_from_jax`` carries an optimizer's state across: the
JAX ``Optimizer.state_dict()`` keys each accumulator by the parameter's
index in the JAX network's parameter order; it is mapped to the port's
parameter of the same name, wherever the port's optimizer lists it, and
the step count comes along, so the bias correction continues.
"""
from __future__ import annotations

import torch

from .framework.io import to_tensor
from .models.bert import BertConfig, BertForPretraining
from .models.llama import LlamaConfig, LlamaForCausalLM
from .nn.layer import Linear


def load_named(model, named_arrays, transposed=frozenset()):
    """Copy every parameter and persistent buffer of ``model`` from the
    entry of its name in ``named_arrays`` (numpy arrays, ``ml_dtypes``
    bf16 included, tensors or ``framework.io.TensorPayload``s; those
    named in ``transposed`` transposed), in place; raises on a missing,
    extra or misshapen name."""
    params = dict(model.state_dict(keep_vars=True))
    missing = sorted(set(params) - set(named_arrays))
    extra = sorted(set(named_arrays) - set(params))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            src = to_tensor(named_arrays[name])
            if name in transposed:
                src = src.t()
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def optimizer_state_from_jax(named_state, jax_param_names, optimizer,
                             network=None) -> dict:
    """Load the JAX ``Optimizer.state_dict()`` ``named_state`` (numpy
    arrays and ints) into the port's ``optimizer``, by name: each
    ``"{acc}_{i}"`` belongs to the JAX parameter ``jax_param_names[i]``
    (the JAX network's parameter names in its optimizer's order) and
    goes to the port parameter of that name, at its index in
    ``optimizer``'s own order.  The port's names come from ``network``'s
    ``named_parameters()``, or from the optimizer's, built from ``(name,
    tensor)`` pairs.  ``@step``, ``@global_step`` and ``LR_Scheduler``
    come along.  Returns the state dict handed to
    ``optimizer.set_state_dict`` (the port's indices)."""
    if network is not None:
        by_name = dict(network.named_parameters())
    else:
        by_name = {optimizer._names[id(p)]: p
                   for p in optimizer._parameter_list
                   if id(p) in optimizer._names}
    index = {id(p): i for i, p in enumerate(optimizer._parameter_list)}
    state = {}
    for key, value in named_state.items():
        acc, _, idx = key.rpartition("_")
        if not acc or not idx.isdigit():
            state[key] = value           # @step, @global_step, LR_Scheduler
            continue
        name = jax_param_names[int(idx)]
        if name not in by_name or id(by_name[name]) not in index:
            raise KeyError(f"{key}: the JAX parameter {name!r} is not a "
                           "parameter of the port's optimizer")
        state[f"{acc}_{index[id(by_name[name])]}"] = value
    optimizer.set_state_dict(state)
    return state


def from_jax_state_dict(named_arrays, config: LlamaConfig, device=None
                        ) -> LlamaForCausalLM:
    """The port's Llama with every parameter copied from ``named_arrays``."""
    return load_named(LlamaForCausalLM(config, device=device, seed=None),
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
    return load_named(model, named_arrays, linear)
