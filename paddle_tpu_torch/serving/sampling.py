"""Per-request sampling for the serving engine (the port of
``paddle_tpu/serving/sampling.py``): temperature, top-k and top-p, with
a per-request seed.

Tokens, not only their distribution, are the JAX package's.  The
reference draws a request's i-th token as
``jax.random.categorical(fold_in(base_key, i), filtered_logits)``: the
Gumbel-max trick over noise whose bits come from Threefry-2x32.  All of
that is integer arithmetic, so this module carries its own copy of it
(:func:`threefry2x32`, in ``int64`` tensors holding ``uint32`` values;
``uint32`` shifts and adds are not implemented on every torch backend)
and reproduces the reference's keys and uniform bits exactly.  Only the
final ``-log(-log(u))`` and the filter's softmax and cumulative sum are
floating point, so a token can differ from the JAX engine's only where
two Gumbel-perturbed logits lie within a few ulps of each other, or
where a top-p cumulative probability lies within a rounding of
``top_p``.

- Keys are ``[S, 2]`` int64 device tensors.  No torch RNG state is read
  or advanced in a step: a request's i-th token always uses
  ``fold_in(base, i)``, independent of slot, batch and preemption.
- Greedy is ``temperature == 0``: such lanes take the argmax of the raw
  logits, bit-identical to the greedy step's, and an engine whose slots
  are all greedy never runs the sampled step.
- The sampler is plain torch ops, as the reference's is XLA (it has no
  Pallas kernel): sorts for the dynamic per-row top-k and top-p, the
  Threefry chain, a log, an argmax.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..jit import GraphStep
from ..models.generation import paged_decode

# key-derivation tags of speculative decoding: the draft proposal, the
# acceptance uniform and the bonus / residual resample of token i each
# fold their own tag on top of the per-token fold
DRAFT_TAG = 0x5D
ACCEPT_TAG = 0xAC
BONUS_TAG = 0xB0

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (``Engine.submit(sampling=...)``).

    ``temperature == 0`` means greedy (argmax), and the engine keeps
    such requests on the greedy decode step.  ``top_k == 0`` and
    ``top_p == 1.0`` disable those filters.  ``seed=None`` draws the
    request's base key from the engine's ``torch.Generator``; a fixed
    seed makes the tokens reproducible whatever the batching, slot or
    preemption."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0

    def base_key(self, generator: Optional[torch.Generator] = None
                 ) -> np.ndarray:
        """The request's base key as ``[2]`` int64 holding uint32 words:
        :func:`prng_key` of the seed, or two words drawn from
        ``generator`` (a CPU ``torch.Generator``) when the seed is
        None."""
        if self.seed is None:
            return torch.randint(0, MASK32 + 1, (2,), generator=generator,
                                 dtype=torch.int64).numpy()
        return prng_key(self.seed)


def resolve_sampling(sampling=None, *, temperature=None, do_sample=False,
                     top_k=0, top_p=1.0, seed=None):
    """One :class:`SamplingParams` from either ``sampling=`` (the params
    or a dict of their fields) or the ``generate()``-style knobs; None
    for greedy.  ``do_sample`` alone means temperature 1; ``top_k``,
    ``top_p`` or ``seed`` at temperature 0 stay greedy."""
    if sampling is not None:
        if isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        if not isinstance(sampling, SamplingParams):
            raise TypeError("sampling= takes a SamplingParams or a dict "
                            f"of its fields, got {type(sampling).__name__}")
        return None if sampling.is_greedy else sampling
    temp = 0.0 if temperature is None else float(temperature)
    if do_sample and temp == 0.0:
        temp = 1.0
    if temp == 0.0:
        return None
    return SamplingParams(temperature=temp, top_k=int(top_k),
                          top_p=float(top_p), seed=seed)


# ---------------------------------------------------------------------------
# the key schedule: Threefry-2x32 as jax.random computes it
# ---------------------------------------------------------------------------

def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as the JAX package computes it (64-bit
    types off): ``[0, seed & 0xFFFFFFFF]``, as int64."""
    return np.asarray([0, int(seed) & MASK32], np.int64)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words ``x0, x1``
    under key words ``k0, k1``: int64 tensors of uint32 values that
    broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def fold_keys(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: ``keys [S, 2]`` int64 folded
    with ``data`` ([S] or a scalar, taken as uint32):
    ``threefry2x32(key, (0, data))``.  A Python int becomes a fill on
    the keys' device, not a copy from the host, so the fold can run
    inside a captured graph."""
    if isinstance(data, int):
        data = torch.full(keys.shape[:-1], data, dtype=torch.int64,
                          device=keys.device)
    data = torch.as_tensor(data, device=keys.device).to(torch.int64)
    data = torch.broadcast_to(data & MASK32, keys.shape[:-1])
    a, b = threefry2x32(keys[..., 0], keys[..., 1],
                        torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def uniform_bits(keys: torch.Tensor, V: int) -> torch.Tensor:
    """``[S, V]`` int64 of 32 random bits each: jax's partitionable
    ``random_bits(key, 32, (V,))`` for every row's key, the two output
    words of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` XOR-ed for
    i in ``range(V)`` (V < 2^32, so the high counter word is 0)."""
    lo = torch.arange(V, device=keys.device, dtype=torch.int64)[None, :]
    a, b = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return a ^ b


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from 32 random bits, as jax makes them: the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """``[S, V]`` f32 Gumbel noise: jax's ``gumbel(key, (V,))`` (mode
    "low") for every row, ``-log(-log(u))`` of ``u = uniform(key,
    minval=tiny)``, which equals the JAX package's bit for bit."""
    f = _unit_floats(uniform_bits(keys, V))
    # jax's f * (1 - tiny) + tiny, where 1 - tiny rounds to 1 in f32
    u = torch.clamp_min(f + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """jax's ``uniform(key, ())`` for every key of ``keys [..., 2]``: one
    f32 in [0, 1) a key, bit for bit (the counter word 0's bits)."""
    lead = keys.shape[:-1]
    bits = uniform_bits(keys.reshape(-1, 2), 1)[:, 0]
    return _unit_floats(bits).reshape(lead)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax's ``categorical(key, logits)`` row by row: the argmax of the
    row's ``gumbel(key, (V,))`` noise plus its logits.  ``keys [N, 2]``,
    ``logits [N, V]`` f32; returns ``[N]`` int64."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def filter_logits(logits, temps, top_ks, top_ps):
    """Temperature, then a per-row dynamic top-k, then top-p over the
    top-k-filtered row.  ``logits [N, V]`` f32; ``temps [N]`` (rows of 0
    are scaled by 1: greedy lanes take the raw argmax); ``top_ks [N]``
    (0 off); ``top_ps [N]`` (1.0 off).  Filtered entries become
    ``-inf``; at least each row's largest survives."""
    v = logits.shape[-1]
    scale = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    scaled = logits / scale
    # top-k: threshold each row at its own k-th largest value
    order = torch.sort(scaled, dim=-1, descending=True).values
    k = top_ks.to(torch.int64).clamp(0, v)
    kth = order.gather(-1, (k - 1).clamp(0, v - 1)[:, None])
    scaled = scaled.masked_fill((k > 0)[:, None] & (scaled < kth),
                                float("-inf"))
    # top-p: keep the largest entries whose mass before them is < top_p
    order = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(order, dim=-1), dim=-1)
    cut = (cum < top_ps[:, None]).sum(-1, keepdim=True).clamp_max(v - 1)
    cutoff = order.gather(-1, cut)
    return scaled.masked_fill((top_ps < 1.0)[:, None] & (scaled < cutoff),
                              float("-inf"))


def filtered_probs(logits, temps, top_ks, top_ps):
    """Softmax of :func:`filter_logits`: each row's sampling
    distribution (filtered entries have probability 0)."""
    return torch.softmax(filter_logits(logits, temps, top_ks, top_ps), -1)


def sample_tokens(logits, temps, top_ks, top_ps, keys):
    """One token a row: the Gumbel-max draw over the filtered logits
    where ``temps > 0``, the argmax of the raw logits elsewhere.  ``keys
    [N, 2]`` are the rows' per-token keys (already folded with the token
    counter).  Returns ``[N]`` int64."""
    sampled = categorical(keys, filter_logits(logits, temps, top_ks, top_ps))
    return torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1))


def sample_at(logits, temps, top_ks, top_ps, keys, counters):
    """Sample each row's token at an explicit counter: the fold and the
    draw that both the engine's first token and its sampled step run, so
    a request's i-th token is the same whichever path draws it."""
    return sample_tokens(logits, temps, top_ks, top_ps,
                         fold_keys(keys, counters))


def make_sampled_decode_step(model, kv_cache_dtype=None, pool=None):
    """The paged decode step followed, on the device, by the fold, the
    filter and the Gumbel argmax: ``step(tok [S, 1], pools, block_tables
    [S, max_blocks], lengths [S], temps [S] f32, top_ks [S], top_ps [S]
    f32, keys [S, 2] int64, counters [S]) -> next_tok [S]`` int64, so
    only S ids go back to the host.  The forward pass is
    ``make_paged_decode_step``'s; greedy lanes (temperature 0) take the
    argmax of its logits.  A :class:`~paddle_tpu_torch.jit.GraphStep`
    as that step is, which binds the five per-slot tensors by address
    as it binds the pools: they are the engine's own, written in place
    for its whole life (``pool``: its graph memory pool)."""
    decode = paged_decode(model, kv_cache_dtype)

    @torch.inference_mode()
    def step(tok, pools, block_tables, lengths, temps, top_ks, top_ps,
             keys, counters):
        last = decode(tok, pools, block_tables, lengths)
        return sample_at(last, temps, top_ks, top_ps, keys, counters)

    return GraphStep(step, model.device, bound=(1, 4, 5, 6, 7, 8),
                     pool=pool)
