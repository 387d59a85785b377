"""Transformer encoder layers (``paddle_tpu/nn/layer/transformer.py:27-167``):
``MultiHeadAttention``, ``TransformerEncoderLayer`` and
``TransformerEncoder``.

Only what BERT runs: self-attention and the post-norm layer
(``normalize_before=False``).  Attention runs through
``functional.scaled_dot_product_attention``, the
plain products of the JAX package's ``_sdpa_reference`` (with its mask
and dropout, BERT stays off the flash kernel in the JAX package too).
Heads are split and merged with ``unflatten`` / ``flatten``, so a
recorded static Program keeps the batch size free.  Each encoder layer
is built on its own (the JAX ``TransformerEncoder`` deep-copies one), so
a seeded model gets different random weights in each layer.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from .layer import Dropout, LayerNorm, Linear


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, *, device=None,
                 dtype=torch.float32, init=None, generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.generator = generator
        kw = dict(device=device, dtype=dtype, init=init)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, x, attn_mask=None):
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(x).unflatten(-1, heads)         # [B, T, H, D]
        k = self.k_proj(x).unflatten(-1, heads)
        v = self.v_proj(x).unflatten(-1, heads)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask, self.dropout, self.training, self.generator)
        return self.out_proj(out.flatten(-2))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (BERT's order): self-attention, then the
    FFN ``linear2(dropout(act(linear1(x))))``, each with a residual and
    a LayerNorm after it."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 init=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            init=init, generator=generator,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, init=init, **kw)
        self.dropout = Dropout(act_dropout, generator)
        self.linear2 = Linear(dim_feedforward, d_model, init=init, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, generator)
        self.dropout2 = Dropout(dropout, generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        src = self.norm1(src + self.dropout1(self.self_attn(src, src_mask)))
        ffn = self.linear2(self.dropout(self.activation(self.linear1(src))))
        return self.norm2(src + self.dropout2(ffn))


class TransformerEncoder(nn.Module):
    """The ``layers`` (each a :class:`TransformerEncoderLayer`) in order."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src
