"""Llama (Llama-2/3 architecture) for the serving path, in PyTorch.

The port of ``paddle_tpu/models/llama.py`` as the continuous-batching
engine runs it in its fused mode: every forward goes through a
:class:`PagedKVCache`, each decoder layer folds its two RMSNorms into
the projections that follow (``kernels.fused_norm_linear``), a decode
step (one token per sequence) takes the fused paged-decode kernel and a
prefill chunk the chunked-prefill kernel.  The final norm is
``kernels.rms_norm``.  The embedding, ``o_proj``, ``down_proj`` and
``lm_head`` are plain matrix products, as the JAX package leaves them to
XLA.

Weights use Paddle's layout: every linear weight is [in, out].  The
RoPE tables are kept in the model's dtype, as the JAX model's
``bfloat16()`` casts its non-persistable buffers, so both packages
compute with the same tables.  The KV pools are updated in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.chunked_prefill import chunked_attention
from ..kernels.fused_norm_linear import fused_norm_linear, rms_scale
from ..kernels.paged_attention import fused_paged_decode
from ..kernels.rms_norm import rms_norm

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
    dtype: str = "bfloat16"

    @staticmethod
    def llama3_8b(**overrides):
        """Meta's published Llama-3-8B shape."""
        cfg = LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=8192,
            rope_theta=500000.0)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    @staticmethod
    def tiny(**overrides):
        cfg = LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, dtype="float32")
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

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
    pool contents (the garbage block 0) are never observable."""

    __slots__ = ("k", "v", "block_table")

    def __init__(self, k, v, block_table):
        self.k = k
        self.v = v
        self.block_table = block_table


class Linear(nn.Module):
    """Bias-free projection with a Paddle-layout [in, out] weight."""

    def __init__(self, weight):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)

    def forward(self, x):
        return x @ self.weight


class LlamaRMSNorm(nn.Module):
    def __init__(self, weight, eps):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, make):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        self.head_dim = hd
        self.q_proj = Linear(make(h, config.num_attention_heads * hd))
        self.k_proj = Linear(make(h, config.num_key_value_heads * hd))
        self.v_proj = Linear(make(h, config.num_key_value_heads * hd))
        self.o_proj = Linear(make(config.num_attention_heads * hd, h))

    def forward(self, hidden, cos, sin, cache: PagedKVCache, positions,
                norm_weight, norm_eps, write_mask=None):
        """The fused serving forward: ``hidden`` is the UNNORMALIZED
        residual stream; the input RMSNorm folds into q/k/v, which share
        one row scale.  ``write_mask`` None means a decode step (T == 1);
        else it is the [B, T] validity mask of a prefill chunk, whose
        padded positions write into the garbage block 0."""
        B, T = hidden.shape[0], hidden.shape[1]
        rs = rms_scale(hidden, norm_eps)
        q = fused_norm_linear(hidden, rs, norm_weight, self.q_proj.weight)
        k = fused_norm_linear(hidden, rs, norm_weight, self.k_proj.weight)
        v = fused_norm_linear(hidden, rs, norm_weight, self.v_proj.weight)
        q = q.reshape(B, T, -1, self.head_dim)
        k = k.reshape(B, T, -1, self.head_dim)
        v = v.reshape(B, T, -1, self.head_dim)
        if write_mask is None:
            if T != 1:
                raise ValueError("a decode step takes one token per "
                                 "sequence; a chunk needs its write mask")
            out, _, _ = fused_paged_decode(q, k, v, cache.k, cache.v,
                                           cache.block_table, positions,
                                           cos, sin)
            return self.o_proj(out.reshape(B, T, -1))
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        _scatter_chunk(cache, k, v, positions, write_mask)
        out = chunked_attention(q, cache.k, cache.v, cache.block_table,
                                positions)
        return self.o_proj(out.reshape(B, T, -1))


def _scatter_chunk(cache: PagedKVCache, k, v, positions, write_mask):
    """Write a chunk's k/v [B, T, KVH, D] into the pools in place: row
    ``block_table[b, pos // bs] * bs + pos % bs`` per position, the
    column clamped to the table, padded positions sent to row 0 (the
    garbage block)."""
    pool = cache.k
    nb, bs = pool.shape[0], pool.shape[1]
    bt = cache.block_table
    T = k.shape[1]
    pos = positions.long()[:, None] + torch.arange(T, device=k.device)
    rows = torch.arange(bt.shape[0], device=k.device)[:, None]
    col = torch.clamp(pos // bs, max=bt.shape[1] - 1)
    idx = bt[rows, col].long() * bs + pos % bs
    idx = torch.where(write_mask, idx, 0).reshape(-1)
    for p, new in ((cache.k, k), (cache.v, v)):
        p.view(nb * bs, p.shape[2], p.shape[3]).index_copy_(
            0, idx, new.reshape(-1, new.shape[2], new.shape[3]).to(p.dtype))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, make):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(make(h, m))
        self.up_proj = Linear(make(h, m))
        self.down_proj = Linear(make(m, h))

    def forward(self, x, norm_weight, norm_eps):
        """The post-attention RMSNorm folds into gate/up (one shared row
        scale); silu rides as gate's epilogue."""
        rs = rms_scale(x, norm_eps)
        g = fused_norm_linear(x, rs, norm_weight, self.gate_proj.weight,
                              activation="silu")
        u = fused_norm_linear(x, rs, norm_weight, self.up_proj.weight)
        return (g * u) @ self.down_proj.weight


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, make, make_norm):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(make_norm(), config.rms_norm_eps)
        self.self_attn = LlamaAttention(config, make)
        self.post_attention_layernorm = LlamaRMSNorm(make_norm(),
                                                     config.rms_norm_eps)
        self.mlp = LlamaMLP(config, make)

    def forward(self, hidden, cos, sin, cache, positions, write_mask=None):
        ln = self.input_layernorm
        hidden = hidden + self.self_attn(hidden, cos, sin, cache, positions,
                                         ln.weight, ln.eps, write_mask)
        ln = self.post_attention_layernorm
        return hidden + self.mlp(hidden, ln.weight, ln.eps)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, make, make_norm, make_embed):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding.from_pretrained(make_embed(),
                                                         freeze=True)
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

    def forward(self, input_ids, caches, positions, write_mask=None,
                last_index=None):
        """Hidden states after the final norm.  ``last_index`` keeps only
        that token's row before the norm (the norm is per row, so the
        result is the same row the full forward would give)."""
        hidden = self.embed_tokens(input_ids)
        for layer, cache in zip(self.layers, caches):
            hidden = layer(hidden, self.rope_cos, self.rope_sin, cache,
                           positions, write_mask)
        if last_index is not None:
            hidden = hidden[:, last_index:last_index + 1]
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"``).  Weights are random from ``seed``
    (normal, std 1/sqrt(fan_in) for projections, 1 for the embedding,
    ones for the norms); ``seed=None`` leaves them uninitialized for a
    loader such as ``convert.from_jax_state_dict`` to fill."""

    def __init__(self, config: LlamaConfig, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dtype = config.torch_dtype
        gen = None
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)

        def make(fan_in, fan_out, std=None):
            w = torch.empty((fan_in, fan_out), dtype=dtype,
                            device=self.device)
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
            self.lm_head = Linear(make(config.hidden_size, config.vocab_size))
        self.eval()

    def forward(self, input_ids, caches, positions, write_mask=None,
                last_index=None):
        """Logits [B, T (or 1 with ``last_index``), V] in the model's
        dtype, over the paged caches (one :class:`PagedKVCache` per
        layer, pools updated in place)."""
        hidden = self.model(input_ids, caches, positions, write_mask,
                            last_index)
        return self.lm_head(hidden)
