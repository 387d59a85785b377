"""Activation recomputation, the port of
``paddle_tpu/distributed/recompute.py``.

``recompute(function, *args)`` runs ``function`` keeping none of its
activations: its backward runs the forward again to rebuild them, then
differentiates it.  The JAX package does that with ``jax.checkpoint``;
here it is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
under which gradients reach both the tensor arguments and the
parameters of the modules ``function`` calls, and the kernels'
``autograd.Function``s (whose state lives in ``ctx`` alone) run a second
time inside the backward.  The replay is the same computation on the
same inputs, so the gradients equal those without recomputation, bit
for bit.

Random draws replay the same numbers.  ``checkpoint``'s
``preserve_rng_state`` restores PyTorch's default generators only; the
port draws dropout masks from explicit ``torch.Generator``s
(``nn.functional.dropout``'s ``generator``, BERT's).  So ``recompute``
notes, during the forward, the state each explicit generator a call is
given had before its first draw, sets those states for the
replay and puts the generators back afterwards: the replay draws the
forward's masks, and a generator's stream after the backward is the one
a run without recomputation leaves.  ``preserve_rng_state=False`` turns
both off.  ``use_reentrant`` is taken for the Paddle signature; the
reentrant form is never used (it cannot take keyword arguments or
restore explicit generators).
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint, noop_context_fn

__all__ = ["RecomputeWrapper", "recompute", "recompute_sequential"]


class _NoteGenerators(TorchFunctionMode):
    """Notes ``{id: (generator, state)}`` of each explicit generator a
    call is given (``generator=``, or an argument of a function that the
    port's ``nn.functional.op`` makes one op, such as dropout's), before
    its first draw."""

    def __init__(self, states):
        super().__init__()
        self.states = states

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for gen in (*args, *kwargs.values()):
            if isinstance(gen, torch.Generator) and \
                    id(gen) not in self.states:
                self.states[id(gen)] = (gen, gen.get_state())
        return func(*args, **kwargs)


@contextlib.contextmanager
def _replayed_generators(states):
    """Each noted generator at its noted state while the block runs,
    then back at the state it had before."""
    before = [(gen, gen.get_state()) for gen, _ in states.values()]
    for gen, state in states.values():
        gen.set_state(state)
    try:
        yield
    finally:
        for gen, state in before:
            gen.set_state(state)


def _generator_contexts():
    states = {}
    return _NoteGenerators(states), _replayed_generators(states)


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """``function(*args, **kwargs)`` under recomputation: its activations
    are dropped and rebuilt by a second forward inside the backward;
    gradients flow to the tensor arguments and to the parameters
    ``function`` reads.  Draws from PyTorch's default generators and
    from explicit ``generator=`` arguments replay the same numbers
    (module docstring)."""
    return checkpoint(
        function, *args, use_reentrant=False,
        preserve_rng_state=preserve_rng_state,
        context_fn=_generator_contexts if preserve_rng_state
        else noop_context_fn, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a sequence of layers in segments (``ctx["segments"]``,
    default 1), each segment one :func:`recompute`; the first argument
    may be left out (then ``functions`` comes first).  ``kwargs`` are
    taken and unused, as in the JAX function."""
    if not isinstance(ctx, dict):  # called without ctx
        functions, args = ctx, (functions,) + args
        ctx = {}
    segments = ctx.get("segments", 1)
    layers = list(functions)
    n = len(layers)
    per = max(n // max(segments, 1), 1)
    x = args[0]
    for i in range(0, n, per):
        def run_chunk(inp, _chunk=tuple(layers[i:i + per])):
            for layer in _chunk:
                inp = layer(inp)
            return inp

        x = recompute(run_chunk, x)
    return x


class RecomputeWrapper:
    """Wrap a layer so that its forward runs under :func:`recompute`."""

    def __init__(self, layer):
        self.layer = layer

    def __call__(self, *args, **kwargs):
        return recompute(self.layer, *args, **kwargs)
