"""The port's neural-network layers (``paddle_tpu/nn``): the functionals
and modules BERT needs, each functional one op to the static recorder,
the loss layers ``hapi.Model`` trains with (``loss``), and gradient
clipping (``clip``)."""
from . import clip, functional, loss
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, Embedding, LayerNorm, Linear
from .loss import CrossEntropyLoss, L1Loss, MSELoss, NLLLoss
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "CrossEntropyLoss", "Dropout", "Embedding", "L1Loss", "LayerNorm",
           "Linear", "MSELoss", "NLLLoss", "loss",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "clip", "functional"]
