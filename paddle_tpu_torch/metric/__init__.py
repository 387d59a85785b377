"""Metrics (the port of ``paddle_tpu/metric``): ``Metric``, ``Accuracy``
(top-k, over class indices [N] or [N, 1] or one-hot labels),
``Precision``, ``Recall`` and ``Auc``.

As in the JAX package, ``compute`` runs where the outputs are (here on
their device: ``Accuracy``'s top-k is one ``torch.topk``) and ``update``
/ ``accumulate`` run on the host over numpy (tensors are copied to
numpy first).  ``hapi.Model`` calls ``update(compute(outputs,
*labels))`` after every batch.  Ties in ``Accuracy``'s top-k may rank
in another order than the JAX package's ``argsort``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """[..., maxk] of 1.0 where the k-th largest prediction is the
        label (f32, on the predictions' device)."""
        label = torch.as_tensor(label).to(pred.device)
        idx = torch.topk(pred, self.maxk, dim=-1).indices
        if label.ndim == pred.ndim:
            if label.shape[-1] == pred.shape[-1] and label.shape[-1] > 1:
                label = label.argmax(-1)            # one-hot
            else:
                label = label[..., 0]               # [N, 1] indices
        return (idx == label[..., None]).float()

    def update(self, correct, *args):
        c = _np(correct)
        num_samples = c.shape[0]
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = c[..., :k].sum()
            accs.append(float(num_corrects) / max(num_samples, 1))
            self.total[i] += num_corrects
            self.count[i] += num_samples
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of predictions above 0.5."""

    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(int).reshape(-1)
        y = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fp += int(((p == 1) & (y == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of predictions above 0.5."""

    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(int).reshape(-1)
        y = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fn += int(((p == 0) & (y == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` bins of the positive class's
    probability (column 1 of [N, 2] predictions), by the trapezoid
    rule."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        y = _np(labels).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        np.add.at(self._stat_pos, bins[y != 0], 1)
        np.add.at(self._stat_neg, bins[y == 0], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = self._stat_pos[::-1].cumsum() / tot_pos
        fpr = self._stat_neg[::-1].cumsum() / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name
