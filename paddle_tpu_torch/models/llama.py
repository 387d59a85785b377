"""Llama (Llama-2/3 architecture) in PyTorch: the serving path and the
no-cache training path.

The port of ``paddle_tpu/models/llama.py`` in two modes.
- Serving, as the continuous-batching engine runs it in its fused mode:
  every forward goes through a :class:`PagedKVCache`, each decoder
  layer folds its two RMSNorms into the projections that follow
  (``kernels.fused_norm_linear``), a decode step (one token per
  sequence) takes the fused paged-decode kernel and a prefill chunk the
  chunked-prefill kernel; the new k/v rows go into the pools through
  ``kernels.kv_quant.kv_write``, quantized as they are written with an
  int8 or fp8 cache.
- Unfused serving (``PagedKVCache.fused`` False, the reference's
  ``fused_kernels=False`` path): ``kernels.rms_norm`` before plain
  q/k/v and gate/up products, RoPE at each sequence's offsets in plain
  torch ops (the reference's gather form), the new rows written through
  ``kernels.kv_quant.kv_write``, and attention as the reference's
  full-buffer masked attention over the pages gathered through the
  block table (a quantized pool's gathered copy dequantized), plain
  torch ops as the reference's is XLA.
- Training (no cache): ``kernels.rms_norm`` before the unfused q/k/v
  and gate/up projections, ``kernels.rope.fused_rope`` on q and k,
  causal ``kernels.flash_attention.flash_attention_bthd``, and with
  ``labels`` the next-token loss, chunked over tokens under
  ``fused_lm_loss`` so the [tokens, vocab] logits never exist whole.
  Every kernel there is differentiable (``torch.autograd.Function``s
  whose backward runs the backward kernels).  Under ``recompute`` each
  decoder layer runs through ``distributed.recompute`` while grad is
  on: its activations are dropped and its forward kernels run again in
  the backward (the JAX model's per-layer ``jax.checkpoint``).
- Mixture of experts (``moe_num_experts > 0``): each layer's MLP is
  :class:`LlamaMoEMLP`, top-k routing through ``kernels.moe_dispatch``.
  In serving, such a layer folds its input RMSNorm into its q/k/v as a
  dense layer does (the JAX layer runs the norm and then plain
  products: the same numbers in f32, ``LlamaRMSNorm``'s cast points);
  its post-attention RMSNorm stays ``kernels.rms_norm``, because
  dispatch reads the normalized rows.
- On a mesh (``distributed.MeshExecutor``, ``hapi.Model(mesh=...)``),
  each parameter is this rank's part and the layers read its placement
  (``distributed.sharded_matmul`` and friends): q/k/v and gate/up are
  column-parallel (each rank its q and kv heads, the same GQA rep),
  o_proj and down_proj row-parallel, the embedding and the head
  vocab-parallel, the norms whole, and ``fsdp`` dims gathered for each
  product; every kernel runs on the rank's local shapes.  The labels'
  loss over a split vocabulary is vocab-parallel, on the logits path and
  in the fused chunked loss alike; a tied table split by rows over tp
  is both the vocab-parallel lookup and the vocab-parallel head.
  Expert stacks split over tp are column-parallel (gate/up) and
  row-parallel (down) within each expert, their partial outputs summed
  in f32 with the expert ranks' before the combine's one rounding.
- Sequence and context parallelism (``sequence_parallel``,
  ``context_parallel`` on a mesh with an ``sp`` axis,
  ``distributed.sequence_parallel``): a rank holds only its T/sp
  positions from the embedding on; RoPE rotates them at the rank's
  offset; the no-cache attention is ring attention
  (``context_parallel="ring"`` or any value but ``"ulysses"``,
  ``kernels.ring_attention``), Ulysses (``"ulysses"``,
  ``kernels.ulysses_attention``), or, with ``sequence_parallel`` alone,
  attention over k and v gathered from the group (causal with Tq < Tk);
  the loss carries the labels across the shard boundaries and divides
  by the whole sequence's count, so each rank's loss and gradients are
  its share of the global ones (summed over ``sp`` by
  ``distributed.MeshExecutor``).  Without an ``sp`` axis both options
  leave the model dense, the JAX model's fallback.
The final norm is ``kernels.rms_norm``.  The embedding, the
projections that no kernel fuses and ``lm_head`` are plain matrix
products, as the JAX package leaves them to XLA.  Under
``tie_word_embeddings`` there is no ``lm_head``: the logits are the
rows times the embedding table [V, hidden] transposed, and the
embedding's gradient sums the lookup's and the head's.

Weights use Paddle's layout: every linear weight is [in, out].  The
RoPE tables are kept in the model's dtype, as the JAX model's
``bfloat16()`` casts its non-persistable buffers, so both packages
compute with the same tables.  The KV pools are updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, tf32_if_exact
from ..distributed.parallel_layers import (_split, column_input,
                                           f32_partial, fsdp_gather,
                                           mp_identity, sharded_embedding,
                                           sharded_matmul,
                                           vocab_parallel_cross_entropy)
from ..distributed.recompute import recompute
from ..distributed.sequence_parallel import (gathered_kv_attention,
                                             next_token_pairs,
                                             sequence_shards)
from ..distributed.sharding import placement_of
from ..kernels.chunked_prefill import chunked_attention
from ..kernels.flash_attention import flash_attention_bthd
from ..kernels.fused_norm_linear import fused_norm_linear_group, rms_scale
from ..kernels.kv_quant import decode_codes, kv_write
from ..kernels.moe_dispatch import moe_capacity, moe_combine, moe_dispatch
from ..kernels.paged_attention import fused_paged_decode
from ..kernels.ring_attention import ring_attention
from ..kernels.rms_norm import rms_norm
from ..kernels.rope import fused_rope
from ..kernels.ulysses_attention import ulysses_attention

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # forward(labels=...) returns (loss, None) with the next-token loss
    # computed lm_loss_chunk tokens at a time (the logits never exist
    # whole); off, it returns (loss, logits)
    fused_lm_loss: bool = False
    lm_loss_chunk: int = 2048
    # mixture of experts: 0 experts is the dense LlamaMLP
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    # the head is the embedding table (no lm_head)
    tie_word_embeddings: bool = False
    # each decoder layer recomputed in the backward (training only)
    recompute: bool = False
    # the sequence split over the mesh's sp axis (module docstring):
    # attention over k/v gathered from the sp ranks ...
    sequence_parallel: bool = False
    # ... or "ring" / "ulysses" attention ("" dense; any other value is
    # ring, as in the JAX model)
    context_parallel: str = ""
    dtype: str = "bfloat16"

    @staticmethod
    def llama3_8b(**overrides):
        """Meta's published Llama-3-8B shape."""
        return dataclasses.replace(LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=8192,
            rope_theta=500000.0), **overrides)

    @staticmethod
    def tiny(**overrides):
        return dataclasses.replace(LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, dtype="float32"), **overrides)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def precompute_rope(head_dim, max_pos, theta, device=None):
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                     # [T, D/2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions):
    """x: [B, T, H, D], rotate-half, token t of sequence b at
    ``positions[b] + t``.  Positions past the table (a padded chunk's
    tail) read its last row, as JAX's clamped gather does; those rows
    are discarded."""
    T = x.shape[1]
    pos = positions.long()[:, None] + torch.arange(T, device=x.device)
    pos = torch.clamp(pos, max=cos.shape[0] - 1)
    c = cos[pos][:, :, None, :]                          # [B, T, 1, D/2]
    s = sin[pos][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


class PagedKVCache:
    """One layer's view of the block pool: ``k``/``v`` [num_blocks,
    block_size, kv_heads, head_dim] shared pools and ``block_table``
    [B, max_blocks] int32 mapping each sequence's logical block to a
    pool block.  Keys past a sequence's frontier are masked, so stale
    pool contents (the garbage block 0) are never observable.

    Quantized pools (``kv_dtype`` ``"int8"``/``"fp8"``,
    ``kernels/kv_quant``) hold int8 codes, and ``k_scale``/``v_scale``
    [num_blocks, block_size] f32 one scale per row: writes quantize,
    the attention kernels dequantize as they read.

    ``fused`` picks the layer's serving path: the fused kernels (True)
    or the reference's unfused path (False), baked into a step when it
    is made, as the reference's ``serving_fusion`` is."""

    __slots__ = ("k", "v", "block_table", "k_scale", "v_scale", "kv_dtype",
                 "fused")

    def __init__(self, k, v, block_table, k_scale=None, v_scale=None,
                 kv_dtype=None, fused=True):
        self.k = k
        self.v = v
        self.block_table = block_table
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.kv_dtype = kv_dtype
        self.fused = fused


class Linear(nn.Module):
    """Bias-free projection with a Paddle-layout [in, out] weight; a
    weight laid out on a mesh takes ``distributed.sharded_matmul``."""

    def __init__(self, weight):
        super().__init__()
        self.weight = nn.Parameter(weight)

    def forward(self, x):
        return sharded_matmul(x, self.weight)


class LlamaRMSNorm(nn.Module):
    def __init__(self, weight, eps):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, make):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        self.head_dim = hd
        self.context_parallel = config.context_parallel
        self.q_proj = Linear(make(h, config.num_attention_heads * hd))
        self.k_proj = Linear(make(h, config.num_key_value_heads * hd))
        self.v_proj = Linear(make(h, config.num_key_value_heads * hd))
        self.o_proj = Linear(make(config.num_attention_heads * hd, h))

    def forward(self, hidden, cos, sin, cache: Optional[PagedKVCache] = None,
                positions=None, norm_weight=None, norm_eps=None,
                write_mask=None, seq=None):
        """Without a cache, the training forward of the NORMALIZED
        ``hidden`` [B, T, h]: unfused q/k/v, RoPE from position 0, causal
        attention; with ``seq`` (``distributed.sequence_parallel.
        SequenceShards``) ``hidden`` is this rank's T/sp positions, RoPE
        starts at its offset and attention covers the whole sequence
        (:meth:`_sequence_attention`).  With a fused one, the serving
        forward: ``hidden`` is the UNNORMALIZED residual stream and the
        input RMSNorm of ``norm_weight`` folds into q/k/v, which share
        one row scale.
        With an unfused one, the reference's unfused serving forward of
        the NORMALIZED ``hidden`` (:meth:`_unfused`).  ``write_mask``
        None means a decode step (T == 1); else it is the [B, T]
        validity mask of a prefill chunk, whose padded positions write
        into the garbage block 0."""
        B, T = hidden.shape[0], hidden.shape[1]
        if cache is None or not cache.fused:
            hidden = column_input(hidden, self.q_proj.weight)
            q = self.q_proj(hidden).reshape(B, T, -1, self.head_dim)
            k = self.k_proj(hidden).reshape(B, T, -1, self.head_dim)
            v = self.v_proj(hidden).reshape(B, T, -1, self.head_dim)
            if cache is not None:
                out = self._unfused(q, k, v, cos, sin, cache, positions,
                                    write_mask)
                return self.o_proj(out.reshape(B, T, -1))
            at = 0 if seq is None else seq.offset
            q, k = fused_rope(q, cos, sin, at), fused_rope(k, cos, sin, at)
            if seq is None:
                out = flash_attention_bthd(q, k, v, causal=True)
            else:
                out = self._sequence_attention(q, k, v, seq)
            return self.o_proj(out.reshape(B, T, -1))
        rs = rms_scale(hidden, norm_eps)
        q, k, v = fused_norm_linear_group(
            hidden, rs, norm_weight,
            [p.weight for p in (self.q_proj, self.k_proj, self.v_proj)],
            ["none"] * 3)
        q = q.reshape(B, T, -1, self.head_dim)
        k = k.reshape(B, T, -1, self.head_dim)
        v = v.reshape(B, T, -1, self.head_dim)
        if write_mask is None:
            if T != 1:
                raise ValueError("a decode step takes one token per "
                                 "sequence; a chunk needs its write mask")
            out = fused_paged_decode(
                q, k, v, cache.k, cache.v, cache.block_table, positions,
                cos, sin, k_scale=cache.k_scale, v_scale=cache.v_scale,
                kv_cache_dtype=cache.kv_dtype)[0]
            return self.o_proj(out.reshape(B, T, -1))
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        _scatter_chunk(cache, k, v, positions, write_mask)
        out = chunked_attention(q, cache.k, cache.v, cache.block_table,
                                positions, cache.k_scale, cache.v_scale,
                                cache.kv_dtype)
        return self.o_proj(out.reshape(B, T, -1))

    def _sequence_attention(self, q, k, v, seq):
        """Causal attention of this rank's positions over the whole
        sequence: Ulysses, ring, or (``sequence_parallel`` alone) the
        keys gathered from the group."""
        cp = self.context_parallel
        if cp == "ulysses":
            return ulysses_attention(q, k, v, causal=True, group=seq.group)
        if cp:
            return ring_attention(q, k, v, causal=True, group=seq.group)
        return gathered_kv_attention(q, k, v, seq)

    def _unfused(self, q, k, v, cos, sin, cache, positions, write_mask):
        """The reference's unfused paged attention (its gather path):
        q and k rotated at each sequence's offsets, the new k/v written
        into the pools (``kv_write``), then :func:`gathered_attention`
        over every page of the block table."""
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        _scatter_chunk(cache, k, v, positions, write_mask)
        return gathered_attention(q, cache, positions)


def gathered_attention(q, cache: PagedKVCache, positions):
    """Causal attention of q [B, T, H, D] at ``positions[b] + t`` over
    the full buffer of pages the block table names, the reference's
    ``_paged_attn``: the pages gathered into a [B, nbs * bs, KVH, D]
    copy in q's dtype (a quantized pool's codes times their row scales),
    f32 scores over 1/sqrt(D), keys past each query's position masked to
    -1e30, an f32 softmax rounded to q's dtype, then the product with
    the values in q's dtype.  A kv head serves its H / KVH query heads
    without a repeated copy."""
    B, T, H, D = q.shape
    bt = cache.block_table.long()
    kb, vb = cache.k[bt], cache.v[bt]           # [B, nbs, bs, KVH, D]
    if cache.kv_dtype is not None:
        kb = (decode_codes(kb, cache.kv_dtype)
              * cache.k_scale[bt][..., None, None]).to(q.dtype)
        vb = (decode_codes(vb, cache.kv_dtype)
              * cache.v_scale[bt][..., None, None]).to(q.dtype)
    KVH = kb.shape[3]
    kb = kb.reshape(B, -1, KVH, D)
    vb = vb.reshape(B, -1, KVH, D)
    qg = q.reshape(B, T, KVH, H // KVH, D)
    scores = torch.einsum("btgrd,bsgd->bgrts", qg.float(), kb.float()) \
        / math.sqrt(D)
    q_pos = positions.long()[:, None] + torch.arange(T, device=q.device)
    k_pos = torch.arange(kb.shape[1], device=q.device)
    valid = k_pos[None, None, :] <= q_pos[:, :, None]          # [B, T, S]
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrts,bsgd->btgrd", probs, vb)
    return out.reshape(B, T, H, D)


def _scatter_chunk(cache: PagedKVCache, k, v, positions, write_mask):
    """Write a chunk's k/v [B, T, KVH, D] into the pools in place: row
    ``block_table[b, pos // bs] * bs + pos % bs`` per position, the
    column clamped to the table, padded positions sent to row 0 (the
    garbage block); a quantized pool gets the rows' codes and scales
    (the reference's ``_scatter`` / ``_scatter_q``; ``kv_quant.kv_write``,
    one launch on the card)."""
    kv_write(cache.k, cache.v, k, v, cache.block_table, positions,
             write_mask=write_mask, k_scale=cache.k_scale,
             v_scale=cache.v_scale, scheme=cache.kv_dtype)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, make):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(make(h, m))
        self.up_proj = Linear(make(h, m))
        self.down_proj = Linear(make(m, h))

    def forward(self, x, norm_weight=None, norm_eps=None):
        """Without ``norm_weight``, the unfused MLP of the normalized x.
        With it, the post-attention RMSNorm folds into gate/up (one
        shared row scale); silu rides as gate's epilogue."""
        if norm_weight is None:
            x = column_input(x, self.gate_proj.weight)
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        rs = rms_scale(x, norm_eps)
        g, u = fused_norm_linear_group(
            x, rs, norm_weight, [self.gate_proj.weight, self.up_proj.weight],
            ["silu", "none"])
        return (g * u) @ self.down_proj.weight


def route_top_k(logits, top_k, dtype):
    """(eidx, sidx, gate) [n, K] of router ``logits`` [n, E]: the top K
    experts of an f32 softmax (a stable descending sort, so ties go to
    the lower expert index as in ``jax.lax.top_k``), each choice's
    capacity slot, the running count of earlier choices of its expert,
    rows major and choices minor (both int32), and the gates renormalized
    to sum to 1 and cast to ``dtype``."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[:, :top_k], order[:, :top_k]
    gate = (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)) \
        .to(dtype)
    flat = eidx.reshape(-1, 1)
    onehot = torch.zeros((flat.shape[0], E), dtype=torch.int32,
                         device=logits.device).scatter_(1, flat, 1)
    sidx = (onehot.cumsum(0, dtype=torch.int32) - onehot).gather(1, flat)
    return eidx.int(), sidx.reshape(-1, top_k), gate


class LlamaMoEMLP(nn.Module):
    """Top-k routed mixture-of-experts MLP, the port of the JAX
    ``LlamaMoEMLP``: GShard capacity-padded routing through
    ``kernels.moe_dispatch`` with stacked expert weights ``w_gate`` /
    ``w_up`` [E, h, m] and ``w_down`` [E, m, h] (the JAX names, so
    ``convert`` maps them as they are) and a ``router`` [h, E].

    Routing is :func:`route_top_k` over the rows of x; choices past
    C = ceil(cf * T * K / E) are dropped.  T counts every row given,
    padded and idle ones included, as the JAX layer does.

    With its stacks laid out on a mesh (``w_gate``/``w_up`` on
    ``(expert, fsdp, tp)``, ``w_down`` on ``(expert, tp, fsdp)``) the
    layer is expert-parallel (``distributed.moe.expert_ffn``): T and the
    slots are global (the lower data ranks' choices counted first), each
    rank runs dispatch and combine over its own experts and their
    gathered ``fsdp`` parts, and the f32 combine is summed over the
    expert ranks before its one rounding.  Stacks split over tp make
    each expert's gate/up column-parallel and down row-parallel: the
    down product's partial rows are f32 (``parallel_layers.f32_partial``,
    every row-parallel product's rule), and the tp ranks join the expert
    ranks' f32 sum."""

    def __init__(self, config: LlamaConfig, make):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        E = config.moe_num_experts
        self.num_experts = E
        self.top_k = config.moe_top_k
        self.capacity_factor = config.moe_capacity_factor
        self.router = Linear(make(h, E))
        self.w_gate = nn.Parameter(make(h, m, experts=E))
        self.w_up = nn.Parameter(make(h, m, experts=E))
        self.w_down = nn.Parameter(make(m, h, experts=E))

    def route(self, x):
        """(eidx, sidx, gate) [n, K] of the rows of x [..., h], gates in
        x's dtype."""
        return route_top_k(self.router(x).reshape(-1, self.num_experts),
                           self.top_k, x.dtype)

    def forward(self, x):
        if placement_of(self.w_gate) is not None:
            return self._expert_parallel(x)
        B, T, h = x.shape
        n = B * T
        C = moe_capacity(n, self.num_experts, self.top_k,
                         self.capacity_factor)
        eidx, sidx, gate = self.route(x)
        disp = moe_dispatch(x.reshape(n, h), eidx, sidx,
                            torch.ones_like(gate), self.num_experts, C)
        g = torch.bmm(disp, self.w_gate)
        u = torch.bmm(disp, self.w_up)
        act = F.silu(g.float()).to(disp.dtype) * u
        eo = torch.bmm(act, self.w_down)
        return moe_combine(eo, eidx, sidx, gate).reshape(B, T, h)

    def _expert_parallel(self, x):
        from ..distributed.moe import ExpertLayout, expert_ffn, global_slots

        B, T, h = x.shape
        n = B * T
        ep = ExpertLayout(self.w_gate, self.num_experts)
        C = moe_capacity(n * ep.data_ranks, self.num_experts, self.top_k,
                         self.capacity_factor)
        eidx, sidx, gate = self.route(x)
        kept = global_slots(eidx, sidx, ep) < C
        wg, wu, wd = (ep.gather(w) for w in (self.w_gate, self.w_up,
                                             self.w_down))

        def ffn(disp):
            g = torch.bmm(disp, wg)
            u = torch.bmm(disp, wu)
            act = F.silu(g.float()).to(disp.dtype) * u
            if ep.tp_axis is None:
                return torch.bmm(act, wd)
            return f32_partial(act, wd)   # rounded once, after the sum

        return expert_ffn(x.reshape(n, h), eidx, sidx, kept, gate, C, ep,
                          ffn).reshape(B, T, h)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, make, make_norm):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(make_norm(), config.rms_norm_eps)
        self.self_attn = LlamaAttention(config, make)
        self.post_attention_layernorm = LlamaRMSNorm(make_norm(),
                                                     config.rms_norm_eps)
        self.moe = config.moe_num_experts > 0
        self.mlp = LlamaMoEMLP(config, make) if self.moe \
            else LlamaMLP(config, make)

    def forward(self, hidden, cos, sin, cache=None, positions=None,
                write_mask=None, seq=None):
        if cache is None or not cache.fused:   # training, unfused serving
            normed = self.input_layernorm(hidden)
            hidden = hidden + self.self_attn(normed, cos, sin, cache,
                                             positions,
                                             write_mask=write_mask, seq=seq)
            return hidden + self.mlp(self.post_attention_layernorm(hidden))
        ln = self.input_layernorm
        hidden = hidden + self.self_attn(hidden, cos, sin, cache, positions,
                                         ln.weight, ln.eps, write_mask)
        ln = self.post_attention_layernorm
        if self.moe:           # dispatch reads the normalized rows
            return hidden + self.mlp(ln(hidden))
        return hidden + self.mlp(hidden, ln.weight, ln.eps)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, make, make_norm, make_embed):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding.from_pretrained(make_embed(),
                                                         freeze=False)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, make, make_norm)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(make_norm(), config.rms_norm_eps)
        dev = self.norm.weight.device
        cos, sin = precompute_rope(config.head_dim,
                                   config.max_position_embeddings,
                                   config.rope_theta, device=dev)
        dtype = config.torch_dtype
        self.register_buffer("rope_cos", cos.to(dtype), persistent=False)
        self.register_buffer("rope_sin", sin.to(dtype), persistent=False)

    def forward(self, input_ids, caches=None, positions=None,
                write_mask=None, last_index=None):
        """Hidden states after the final norm; without ``caches`` the
        no-cache (training) forward from position 0, each layer under
        :func:`recompute` when the config asks for it and grad is on
        (a no-grad forward, such as an eval, runs the layers as they
        are).  ``last_index`` (an
        int, or an int tensor of one element on the model's device, as
        a captured step passes it) keeps only that token's row before
        the norm (the norm is per row, so the result is the same row the
        full forward would give).  On a mesh whose ``sp`` axis splits the
        sequence (:meth:`shards`), ``input_ids`` are this rank's T/sp
        positions and so are the rows returned."""
        hidden = sharded_embedding(input_ids, self.embed_tokens.weight)
        seq = None
        if caches is None:
            seq = self.shards(input_ids)
            if self.config.recompute and torch.is_grad_enabled():
                for layer in self.layers:
                    hidden = recompute(layer, hidden, self.rope_cos,
                                       self.rope_sin, seq=seq)
                return self.norm(hidden)
            caches = [None] * len(self.layers)
        for layer, cache in zip(self.layers, caches):
            hidden = layer(hidden, self.rope_cos, self.rope_sin, cache,
                           positions, write_mask, seq)
        if isinstance(last_index, torch.Tensor):
            hidden = hidden.index_select(1, last_index.reshape(1))
        elif last_index is not None:
            hidden = hidden[:, last_index:last_index + 1]
        return self.norm(hidden)


    def shards(self, input_ids):
        """This rank's part of the sequence (``SequenceShards``) when
        the model splits it over the active mesh's ``sp`` axis, else
        None (``distributed.sequence_parallel.sequence_shards``)."""
        return sequence_shards(self.config, input_ids.shape[1])


def causal_lm_loss(logits, labels, vocab_group=None, seq=None):
    """Mean next-token NLL over every position of logits [B, T, V] (the
    JAX forward's unfused ``causal_lm_loss``: f32 log-softmax, labels
    shifted by one).  With ``vocab_group`` the logits are this rank's
    part of the vocabulary, and the softmax runs over the group
    (``distributed.vocab_parallel_cross_entropy``).  With ``seq`` the
    logits and labels are this rank's positions: the sum over its
    predicted tokens divided by the whole sequence's count
    (``next_token_pairs``), its share of the global mean."""
    lg, lab, count = next_token_pairs(logits, labels, seq)
    if vocab_group is not None:
        nll = vocab_parallel_cross_entropy(lg, lab.long(), vocab_group)
    else:
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -logp.gather(-1, lab[..., None].long())[..., 0]
    return nll.mean() if seq is None else nll.sum() / count


class _F32Logits(torch.autograd.Function):
    """f32 logits ``h @ w`` of model-dtype rows h [n, hidden] against the
    f32 weight w [hidden, V], as the JAX ``preferred_element_type=f32``
    product gives them.  The precision is chosen here, not left to the
    caller's process-wide setting: with bf16 rows both forward operands
    are exact in TF32, so the product runs on the tensor cores and its
    logits are the f32 ones; the backward's products round the f32
    cotangent to TF32 (2^-11 relative) before dh is rounded to bf16
    (2^-9) and dw, summed over the chunks in f32, to the weight's
    dtype.  f32 rows keep full f32 products."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        with tf32_if_exact(h.dtype):
            return h.float() @ w

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = dw = None
        with tf32_if_exact(h.dtype):
            if ctx.needs_input_grad[0]:
                dh = (g @ w.t()).to(h.dtype)
            if ctx.needs_input_grad[1]:
                dw = h.float().t() @ g
        return dh, dw


def _chunk_nll(h, w, labels, group=None):
    """Summed NLL of one token chunk: h [n, hidden] against the f32
    head weight w [hidden, V] (a transposed view when tied); labels -1
    are padding.  With ``group``, w holds this rank's V/n columns of the
    vocabulary and the softmax runs over the group
    (``distributed.vocab_parallel_cross_entropy``: the max, then the sum
    of exponentials with the target's logit, two collectives, counted
    under ``fused_loss``)."""
    logits = _F32Logits.apply(h, w)
    if group is not None:
        from ..distributed.collective import counted_under

        with counted_under("fused_loss"):
            return vocab_parallel_cross_entropy(logits, labels, group,
                                                ignore_index=-1).sum()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp(min=0)[:, None])[:, 0]
    return ((lse - picked) * (labels >= 0).float()).sum()


def fused_causal_lm_loss(hidden, w, labels, chunk, w_is_vocab_major=False,
                         seq=None, vocab_group=None):
    """The JAX ``_fused_causal_lm_loss``: next-token NLL computed
    ``chunk`` tokens at a time, each chunk's logits recomputed in the
    backward (``torch.utils.checkpoint`` in place of ``jax.checkpoint``)
    so the [tokens, V] logits never exist whole; padded tokens carry the
    label -1; the sum is divided by the token count.

    The logits are f32 from the model-dtype operands (:class:`_F32Logits`):
    the hidden rows and an f32 copy of the weight (made once, its
    gradient summed over the chunks in f32) go through an f32 matrix
    product, in TF32 on the card when the rows are bf16.  ``w`` is
    [hidden, V], or with ``w_is_vocab_major`` the tied embedding table
    [V, hidden], whose f32 copy the products read through a transposed
    view (no second copy of the table).  With ``seq`` (this rank's
    positions of a split sequence) the sum is divided by the whole
    sequence's count (``next_token_pairs``).

    With ``vocab_group`` (the tp group a vocabulary split over tp ranks
    lies on), ``w`` is this rank's part of the head, V/n columns (rows
    of a tied table), each chunk's NLL is vocab-parallel
    (:func:`_chunk_nll`), and the rows' gradient is summed over the
    group, as a column-parallel input's is."""
    if vocab_group is not None:
        hidden = mp_identity(hidden, vocab_group)
    h, lab, count = next_token_pairs(hidden, labels, seq)
    lab = lab.long()
    B, T, H = h.shape
    n_tok = B * T
    hf = h.reshape(n_tok, H)
    labf = lab.reshape(n_tok)
    n_chunks = max(1, -(-n_tok // chunk))
    csize = -(-n_tok // n_chunks)
    pad = n_chunks * csize - n_tok
    if pad:
        hf = F.pad(hf, (0, 0, 0, pad))
        labf = F.pad(labf, (0, pad), value=-1)
    wf = w.float().t() if w_is_vocab_major else w.float()
    total = hidden.new_zeros((), dtype=torch.float32)
    for c in range(n_chunks):
        rows = slice(c * csize, (c + 1) * csize)
        total = total + checkpoint(_chunk_nll, hf[rows], wf, labf[rows],
                                   vocab_group, use_reentrant=False)
    return total / count


class LlamaForCausalLM(nn.Module):
    """Llama causal LM on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"``).  Weights are random from ``seed``
    (normal, std 1/sqrt(fan_in) for projections, the router and the
    expert stacks, 1 for the embedding, ones for the norms), drawn in
    the order of the modules, ``lm_head`` last (a tied model has none);
    ``seed=None`` leaves them uninitialized for a loader such as
    ``convert.from_jax_state_dict`` to fill.  Every parameter is
    trainable."""

    #: the parameters' names carry the canonical Llama roles
    #: (``sharding.llama_param_role``): fleet lays the model's Megatron
    #: parts out over ``mp`` by role
    canonical_layout = True

    def __init__(self, config: LlamaConfig, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dtype = config.torch_dtype
        gen = None
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)

        def make(fan_in, fan_out, std=None, experts=None):
            shape = (fan_in, fan_out) if experts is None \
                else (experts, fan_in, fan_out)
            w = torch.empty(shape, dtype=dtype, device=self.device)
            if gen is not None:
                w.normal_(0.0, std or 1.0 / math.sqrt(fan_in), generator=gen)
            return w

        def make_norm():
            return torch.ones(config.hidden_size, dtype=dtype,
                              device=self.device)

        def make_embed():
            return make(config.vocab_size, config.hidden_size, std=1.0)

        with torch.no_grad():
            self.model = LlamaModel(config, make, make_norm, make_embed)
            if not config.tie_word_embeddings:
                self.lm_head = Linear(make(config.hidden_size,
                                           config.vocab_size))

    def logits(self, hidden):
        """The head: ``hidden @ lm_head.weight``, or tied ``hidden @
        embed_tokens.weight.t()``, in the model's dtype.  A head laid out
        on a mesh gives this rank's part of the vocabulary when the
        vocabulary is split over tp."""
        if self.config.tie_word_embeddings:
            w = self.model.embed_tokens.weight
            group = self._vocab_group()
            if group is not None:     # the table's rows are the vocab's
                hidden = mp_identity(hidden, group)
            return hidden @ fsdp_gather(w).t()
        return self.lm_head(column_input(hidden, self.lm_head.weight))

    def _vocab_group(self):
        """The tp group the logits' vocabulary is split over, or None."""
        w = self.model.embed_tokens.weight if \
            self.config.tie_word_embeddings else self.lm_head.weight
        pl = placement_of(w)
        if pl is None:
            return None
        mdim, group, _ = _split(pl)
        vocab_dim = 0 if self.config.tie_word_embeddings else 1
        return group if mdim == vocab_dim else None

    def forward(self, input_ids, caches=None, positions=None,
                write_mask=None, last_index=None, labels=None):
        """Serving (``caches``: one :class:`PagedKVCache` per layer, pools
        updated in place): logits [B, T (or 1 with ``last_index``), V] in
        the model's dtype.  Without caches, the training forward from
        position 0: logits [B, T, V]; with ``labels`` [B, T] (the next
        token of position t is ``labels[:, t + 1]``) ``(loss, None)``
        under ``fused_lm_loss`` and ``(loss, logits)`` otherwise.  On a
        mesh whose ``sp`` axis splits the sequence, ``input_ids`` and
        ``labels`` are this rank's positions (cut alike), the logits
        its rows and the loss its share of the global mean (the labels
        carried across the boundary, the whole sequence's count)."""
        if labels is not None and caches is not None:
            raise ValueError("labels belong to the no-cache forward")
        hidden = self.model(input_ids, caches, positions, write_mask,
                            last_index)
        if labels is None:
            return self.logits(hidden)
        labels_seq = self.model.shards(input_ids)
        vocab_group = self._vocab_group()
        if self.config.fused_lm_loss:
            tied = self.config.tie_word_embeddings
            w = self.model.embed_tokens.weight if tied else self.lm_head.weight
            return fused_causal_lm_loss(hidden, fsdp_gather(w), labels,
                                        self.config.lm_loss_chunk,
                                        w_is_vocab_major=tied,
                                        seq=labels_seq,
                                        vocab_group=vocab_group), None
        logits = self.logits(hidden)
        return causal_lm_loss(logits, labels, vocab_group,
                              labels_seq), logits
