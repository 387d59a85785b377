"""BERT (``paddle_tpu/models/bert.py``; BASELINE.md config 2: BERT-base
pretraining) on the port's transformer layers.

``BertConfig.base()`` is Google's published ``bert_config.json`` for
BERT-Base Uncased (google-research/bert): vocab 30522, hidden 768, 12
layers, 12 heads, FFN 3072, gelu, dropout 0.1, 512 positions, 2 token
types.  Each encoder layer's FFN is ``linear1`` followed by exact gelu
and the MLM head is ``mlm_transform`` followed by gelu: the linear ->
activation pairs that the static pass ``fuse_linear_act`` rewrites into
``kernels.fused_linear``.  The MLM logits are one ``linear`` op that
reads the word-embedding table and ``mlm_bias`` directly.

The models run eagerly (dygraph) or are recorded into a static Program
(``static.program_guard``); the position ids come from an op on the
input ids, so a recorded Program looks the position table up at run time
(the JAX package folds that lookup into a constant while recording; see
ROADMAP §C).  Weights are random from ``seed`` (normal with std
``initializer_range``, biases zero, norms one, BERT's initialization),
or uninitialized with ``seed=None`` for ``convert.bert_from_jax`` to
fill.  Dropout masks come from ``generator`` (``None``: PyTorch's
default generator).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layer import EMPTY, Dropout, Embedding, LayerNorm, Linear
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer
from .llama import DTYPES


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: str = "float32"

    @staticmethod
    def base(**overrides):
        return dataclasses.replace(BertConfig(), **overrides)

    @staticmethod
    def tiny(**overrides):
        return dataclasses.replace(BertConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, type_vocab_size=2), **overrides)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@F.op("position_ids")
def position_ids(input_ids):
    """[1, T] positions 0 .. T - 1 of ``input_ids`` [B, T]."""
    return torch.arange(input_ids.shape[-1],
                        device=input_ids.device)[None]


class _Init:
    """Arguments every layer of a model is built with."""

    def __init__(self, config: BertConfig, device, seed, generator):
        self.device = resolve_device(device)
        self.dtype = config.torch_dtype
        self.std = config.initializer_range
        self.init = EMPTY if seed is None else torch.Generator(
            device=self.device).manual_seed(seed)
        self.generator = generator

    def layer(self, **extra):
        return dict(device=self.device, dtype=self.dtype, **extra)

    def weights(self):
        return self.layer(init=self.init, init_std=self.std)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, mk: _Init):
        super().__init__()
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **mk.weights())
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            **mk.weights())
        self.token_type_embeddings = Embedding(
            config.type_vocab_size, config.hidden_size, **mk.weights())
        self.layer_norm = LayerNorm(config.hidden_size,
                                    config.layer_norm_eps, **mk.layer())
        self.dropout = Dropout(config.hidden_dropout_prob, mk.generator)

    def forward(self, input_ids, token_type_ids=None):
        emb = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids(input_ids))
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, mk: _Init):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, mk)
        self.encoder = TransformerEncoder([TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps,
            **mk.layer(init=mk.init, generator=mk.generator))
            for _ in range(config.num_hidden_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             **mk.weights())

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            # [B, T] (1 = keep) -> additive [B, 1, 1, T]
            mask = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
        seq = self.encoder(emb, mask)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForPretraining(nn.Module):
    """MLM + NSP heads on ``device`` (default ``cuda``)."""

    def __init__(self, config: BertConfig, device=None,
                 seed: Optional[int] = 0, generator=None):
        super().__init__()
        mk = _Init(config, device, seed, generator)
        self.config = config
        self.device = mk.device
        self.bert = BertModel(config, mk)
        self.mlm_transform = Linear(config.hidden_size, config.hidden_size,
                                    **mk.weights())
        self.mlm_norm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                  **mk.layer())
        self.mlm_bias = nn.Parameter(torch.zeros(
            config.vocab_size, device=mk.device, dtype=mk.dtype))
        self.nsp_head = Linear(config.hidden_size, 2, **mk.weights())

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        logits = F.linear(h, self.bert.embeddings.word_embeddings.weight,
                          self.mlm_bias)
        nsp_logits = self.nsp_head(pooled)
        if masked_lm_labels is None:
            return logits, nsp_logits
        total = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                masked_lm_labels.reshape(-1))
        if next_sentence_labels is not None:
            total = total + F.cross_entropy(nsp_logits, next_sentence_labels)
        return total, logits, nsp_logits


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes=2, device=None,
                 seed: Optional[int] = 0, generator=None):
        super().__init__()
        mk = _Init(config, device, seed, generator)
        self.device = mk.device
        self.bert = BertModel(config, mk)
        self.dropout = Dropout(config.hidden_dropout_prob, generator)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 **mk.weights())

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits
