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
- Training (no cache): ``kernels.rms_norm`` before the unfused q/k/v
  and gate/up projections, ``kernels.rope.fused_rope`` on q and k,
  causal ``kernels.flash_attention.flash_attention_bthd``, and with
  ``labels`` the next-token loss, chunked over tokens under
  ``fused_lm_loss`` so the [tokens, vocab] logits never exist whole.
  Every kernel there is differentiable (``torch.autograd.Function``s
  whose backward runs the backward kernels).
- Mixture of experts (``moe_num_experts > 0``): each layer's MLP is
  :class:`LlamaMoEMLP`, top-k routing through ``kernels.moe_dispatch``.
  In serving, such a layer folds its input RMSNorm into its q/k/v as a
  dense layer does (the JAX layer runs the norm and then plain
  products: the same numbers in f32, ``LlamaRMSNorm``'s cast points);
  its post-attention RMSNorm stays ``kernels.rms_norm``, because
  dispatch reads the normalized rows.
The final norm is ``kernels.rms_norm``.  The embedding, the
projections that no kernel fuses and ``lm_head`` are plain matrix
products, as the JAX package leaves them to XLA.

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
from ..kernels.chunked_prefill import chunked_attention
from ..kernels.flash_attention import flash_attention_bthd
from ..kernels.fused_norm_linear import fused_norm_linear_group, rms_scale
from ..kernels.kv_quant import kv_write
from ..kernels.moe_dispatch import moe_capacity, moe_combine, moe_dispatch
from ..kernels.paged_attention import fused_paged_decode
from ..kernels.rms_norm import rms_norm
from ..kernels.rope import fused_rope

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
    # options of the JAX model that the port does not have yet: anything
    # but these values raises NotImplementedError
    tie_word_embeddings: bool = False
    sequence_parallel: bool = False
    recompute: bool = False
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
    the attention kernels dequantize as they read."""

    __slots__ = ("k", "v", "block_table", "k_scale", "v_scale", "kv_dtype")

    def __init__(self, k, v, block_table, k_scale=None, v_scale=None,
                 kv_dtype=None):
        self.k = k
        self.v = v
        self.block_table = block_table
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.kv_dtype = kv_dtype


class Linear(nn.Module):
    """Bias-free projection with a Paddle-layout [in, out] weight."""

    def __init__(self, weight):
        super().__init__()
        self.weight = nn.Parameter(weight)

    def forward(self, x):
        return x @ self.weight


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
        self.q_proj = Linear(make(h, config.num_attention_heads * hd))
        self.k_proj = Linear(make(h, config.num_key_value_heads * hd))
        self.v_proj = Linear(make(h, config.num_key_value_heads * hd))
        self.o_proj = Linear(make(config.num_attention_heads * hd, h))

    def forward(self, hidden, cos, sin, cache: Optional[PagedKVCache] = None,
                positions=None, norm_weight=None, norm_eps=None,
                write_mask=None):
        """Without a cache, the training forward of the NORMALIZED
        ``hidden`` [B, T, h]: unfused q/k/v, RoPE from position 0, causal
        attention.  With one, the serving forward: ``hidden`` is the
        UNNORMALIZED residual stream and the input RMSNorm of
        ``norm_weight`` folds into q/k/v, which share one row scale.
        ``write_mask`` None means a decode step (T == 1); else
        it is the [B, T] validity mask of a prefill chunk, whose padded
        positions write into the garbage block 0."""
        B, T = hidden.shape[0], hidden.shape[1]
        if cache is None:
            q = self.q_proj(hidden).reshape(B, T, -1, self.head_dim)
            k = self.k_proj(hidden).reshape(B, T, -1, self.head_dim)
            v = self.v_proj(hidden).reshape(B, T, -1, self.head_dim)
            q, k = fused_rope(q, cos, sin), fused_rope(k, cos, sin)
            out = flash_attention_bthd(q, k, v, causal=True)
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
    padded and idle ones included, as the JAX layer does."""

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
                write_mask=None):
        if cache is None:      # the training forward
            normed = self.input_layernorm(hidden)
            hidden = hidden + self.self_attn(normed, cos, sin)
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
        no-cache (training) forward from position 0.  ``last_index`` (an
        int, or an int tensor of one element on the model's device, as
        a captured step passes it) keeps only that token's row before
        the norm (the norm is per row, so the result is the same row the
        full forward would give)."""
        hidden = self.embed_tokens(input_ids)
        if caches is None:
            caches = [None] * len(self.layers)
        for layer, cache in zip(self.layers, caches):
            hidden = layer(hidden, self.rope_cos, self.rope_sin, cache,
                           positions, write_mask)
        if isinstance(last_index, torch.Tensor):
            hidden = hidden.index_select(1, last_index.reshape(1))
        elif last_index is not None:
            hidden = hidden[:, last_index:last_index + 1]
        return self.norm(hidden)


def causal_lm_loss(logits, labels):
    """Mean next-token NLL over every position of logits [B, T, V] (the
    JAX forward's unfused ``causal_lm_loss``: f32 log-softmax, labels
    shifted by one)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = logp.gather(-1, labels[:, 1:, None].long())[..., 0]
    return -picked.mean()


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


def _chunk_nll(h, w, labels):
    """Summed NLL of one token chunk: h [n, hidden] against the f32
    lm_head weight w [hidden, V]; labels -1 are padding."""
    logits = _F32Logits.apply(h, w)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp(min=0)[:, None])[:, 0]
    return ((lse - picked) * (labels >= 0).float()).sum()


def fused_causal_lm_loss(hidden, w, labels, chunk):
    """The JAX ``_fused_causal_lm_loss``: next-token NLL computed
    ``chunk`` tokens at a time, each chunk's logits recomputed in the
    backward (``torch.utils.checkpoint`` in place of ``jax.checkpoint``)
    so the [tokens, V] logits never exist whole; padded tokens carry the
    label -1; the sum is divided by the token count.

    The logits are f32 from the model-dtype operands (:class:`_F32Logits`):
    the hidden rows and an f32 copy of the weight (made once, its
    gradient summed over the chunks in f32) go through an f32 matrix
    product, in TF32 on the card when the rows are bf16."""
    h = hidden[:, :-1]
    lab = labels[:, 1:].long()
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
    wf = w.float()
    total = hidden.new_zeros((), dtype=torch.float32)
    for c in range(n_chunks):
        rows = slice(c * csize, (c + 1) * csize)
        total = total + checkpoint(_chunk_nll, hf[rows], wf, labf[rows],
                                   use_reentrant=False)
    return total / n_tok


# options of the JAX LlamaConfig the port does not have yet, with the one
# value each may take
UNPORTED_OPTIONS = {"tie_word_embeddings": False, "sequence_parallel": False,
                    "recompute": False, "context_parallel": ""}


class LlamaForCausalLM(nn.Module):
    """Llama causal LM on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"``).  Weights are random from ``seed``
    (normal, std 1/sqrt(fan_in) for projections, the router and the
    expert stacks, 1 for the embedding, ones for the norms); ``seed=None`` leaves them uninitialized for a
    loader such as ``convert.from_jax_state_dict`` to fill.  Every
    parameter is trainable."""

    def __init__(self, config: LlamaConfig, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        for option, value in UNPORTED_OPTIONS.items():
            if getattr(config, option) != value:
                raise NotImplementedError(
                    f"LlamaConfig.{option}={getattr(config, option)!r} is "
                    "not ported to paddle_tpu_torch yet")
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
            self.lm_head = Linear(make(config.hidden_size, config.vocab_size))

    def forward(self, input_ids, caches=None, positions=None,
                write_mask=None, last_index=None, labels=None):
        """Serving (``caches``: one :class:`PagedKVCache` per layer, pools
        updated in place): logits [B, T (or 1 with ``last_index``), V] in
        the model's dtype.  Without caches, the training forward from
        position 0: logits [B, T, V]; with ``labels`` [B, T] (the next
        token of position t is ``labels[:, t + 1]``) ``(loss, None)``
        under ``fused_lm_loss`` and ``(loss, logits)`` otherwise."""
        if labels is not None and caches is not None:
            raise ValueError("labels belong to the no-cache forward")
        hidden = self.model(input_ids, caches, positions, write_mask,
                            last_index)
        if labels is None:
            return self.lm_head(hidden)
        if self.config.fused_lm_loss:
            return fused_causal_lm_loss(hidden, self.lm_head.weight, labels,
                                        self.config.lm_loss_chunk), None
        logits = self.lm_head(hidden)
        return causal_lm_loss(logits, labels), logits
