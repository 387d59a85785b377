"""Loss layers (``paddle_tpu/nn/layer/loss.py``): ``CrossEntropyLoss``,
``MSELoss``, ``L1Loss`` and ``NLLLoss`` as ``torch.nn.Module``s over the
one-op functionals of :mod:`.functional`.  A ``weight`` (a tensor or an
array of one entry a class) follows the input to its device."""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F


def _weight(weight, like):
    return None if weight is None else \
        torch.as_tensor(weight).to(like.device)


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, _weight(self.weight, input), self.ignore_index,
            self.reduction, self.soft_label, self.axis, self.use_softmax,
            self.label_smoothing)


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(nn.Module):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, _weight(self.weight, input),
                          self.ignore_index, self.reduction)
