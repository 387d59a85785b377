"""The port's neural-network layers (``paddle_tpu/nn``): the functionals
and modules BERT needs, each functional one op to the static recorder,
and gradient clipping (``clip``)."""
from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, Embedding, LayerNorm, Linear
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "clip", "functional"]
