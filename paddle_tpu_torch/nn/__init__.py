"""The port's neural-network layers (``paddle_tpu/nn``): the functionals
and modules BERT needs, each functional one op to the static recorder."""
from . import functional
from .layer import Dropout, Embedding, LayerNorm, Linear
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "functional"]
