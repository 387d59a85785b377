"""The port's ``io`` (datasets, samplers, collate, ``DataLoader``),
``metric`` and ``nn`` loss layers against the JAX package's, on the same
numpy inputs.

The JAX samplers draw from numpy's global random state; the port's
from an explicit ``RandomState``.  Seeding both with one seed gives the
same permutations, draws and batches, compared exactly.  Metrics are
compared exactly (the same host arithmetic over numpy); losses within
LOSS_TOL (f32; the packages sum in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import static

LOSS_TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same_tree(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_tree(got[k], want[k])
    else:
        g, w = _np(got), _np(want)
        assert g.dtype == w.dtype or (w.dtype == np.int32 and
                                      g.dtype == np.int64), (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _data(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.int64))


class _Squares(jio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.float32(i * i), i

    def __len__(self):
        return self.n


class _TSquares(tio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.float32(i * i), i

    def __len__(self):
        return self.n


class _Stream(tio.IterableDataset):
    def __iter__(self):
        return iter(range(7))


class _JStream(jio.IterableDataset):
    def __iter__(self):
        return iter(range(7))


class TestDatasets:
    def test_tensor_compose_concat_subset(self):
        x, y = _data()
        jt, tt = jio.TensorDataset([x, y]), tio.TensorDataset([x, y])
        assert len(tt) == len(jt) == 10
        for i in (0, 3, 9):
            _same_tree(tt[i], jt[i])
        jc = jio.ComposeDataset([jt, _Squares(8)])
        tc = tio.ComposeDataset([tt, _TSquares(8)])
        assert len(tc) == len(jc) == 8
        _same_tree(tc[5], jc[5])
        jcat = jio.ConcatDataset([jt, _Squares(4)])
        tcat = tio.ConcatDataset([tt, _TSquares(4)])
        assert len(tcat) == len(jcat) == 14
        for i in (0, 9, 10, 13, -1):
            _same_tree(tcat[i], jcat[i])
        js, ts = jio.Subset(jt, [4, 1, 7]), tio.Subset(tt, [4, 1, 7])
        assert len(ts) == 3
        _same_tree(ts[2], js[2])

    def test_chain_and_iterable(self):
        # iterated, not list()ed: list() asks for a length, which an
        # IterableDataset refuses in both packages
        got = [x for x in tio.ChainDataset([_Stream(), _Stream()])]
        want = [x for x in jio.ChainDataset([_JStream(), _JStream()])]
        assert got == want == list(range(7)) * 2
        with pytest.raises(RuntimeError):
            len(_Stream())
        with pytest.raises(RuntimeError):
            _Stream()[0]

    @pytest.mark.parametrize("lengths", [[3, 7], [0.3, 0.7], [5, 2, 3]])
    def test_random_split_same_seed(self, lengths):
        x, y = _data()
        np.random.seed(4)
        want = jio.random_split(jio.TensorDataset([x, y]), lengths)
        got = tio.random_split(tio.TensorDataset([x, y]), lengths,
                               generator=np.random.RandomState(4))
        assert [s.indices for s in got] == [s.indices for s in want]
        with pytest.raises(ValueError):
            tio.random_split(tio.TensorDataset([x, y]), [3, 3])


class TestSamplers:
    def test_sequence(self):
        assert list(tio.SequenceSampler(range(5))) == \
            list(jio.SequenceSampler(range(5)))

    @pytest.mark.parametrize("kw", [{}, {"num_samples": 6},
                                    {"replacement": True, "num_samples": 12}])
    def test_random_same_seed(self, kw):
        np.random.seed(7)
        js = jio.RandomSampler(range(10), **kw)
        want = [list(js), list(js)]
        ts = tio.RandomSampler(range(10), generator=np.random.RandomState(7),
                               **kw)
        assert [list(ts), list(ts)] == want
        assert len(ts) == len(js)

    def test_random_takes_a_generator(self):
        a = list(tio.RandomSampler(range(10),
                                   generator=np.random.default_rng(3)))
        b = list(tio.RandomSampler(range(10),
                                   generator=np.random.default_rng(3)))
        assert a == b and sorted(a) == list(range(10))
        state = np.random.get_state()[1].copy()
        list(tio.RandomSampler(range(10)))       # unseeded, own state
        assert np.array_equal(np.random.get_state()[1], state)

    @pytest.mark.parametrize("replacement", [True, False])
    def test_weighted_same_seed(self, replacement):
        w = [0.1, 0.4, 0.2, 0.3, 0.5]
        np.random.seed(2)
        want = list(jio.WeightedRandomSampler(w, 4, replacement))
        got = list(tio.WeightedRandomSampler(
            w, 4, replacement, generator=np.random.RandomState(2)))
        assert got == want

    @pytest.mark.parametrize("drop_last", [False, True])
    @pytest.mark.parametrize("shuffle", [False, True])
    def test_batch_sampler(self, shuffle, drop_last):
        np.random.seed(5)
        jb = jio.BatchSampler(range(11), shuffle=shuffle, batch_size=3,
                              drop_last=drop_last)
        want = list(jb)
        tb = tio.BatchSampler(range(11), shuffle=shuffle, batch_size=3,
                              drop_last=drop_last,
                              generator=np.random.RandomState(5))
        assert list(tb) == want and len(tb) == len(jb)
        sampler = tio.SequenceSampler(range(4))
        assert list(tio.BatchSampler(sampler=sampler, batch_size=3)) == \
            [[0, 1, 2], [3]]


class TestCollateAndLoader:
    def test_collate(self):
        x, y = _data(4)
        for batch in ([x[0], x[1]], [1, 2, 3], [0.5, 1.5],
                      [(x[0], 1), (x[1], 2)],
                      [{"a": x[0], "b": 1.0}, {"a": x[1], "b": 2.0}]):
            _same_tree(tio.default_collate_fn(batch),
                       jio.default_collate_fn(batch))
        stacked = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
        assert stacked.shape == (2, 2)

    @pytest.mark.parametrize("kw", [
        dict(batch_size=3), dict(batch_size=3, drop_last=True),
        dict(batch_size=4, shuffle=True), dict(batch_size=None)])
    def test_loader_batches(self, kw):
        x, y = _data()
        np.random.seed(9)
        want = list(jio.DataLoader(jio.TensorDataset([x, y]), **kw))
        loader = tio.DataLoader(tio.TensorDataset([x, y]),
                                generator=np.random.RandomState(9), **kw)
        got = list(loader)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            _same_tree(g, w)

    def test_loader_over_an_iterable_dataset(self):
        got = [b for b in tio.DataLoader(_Stream(), batch_size=3)]
        want = [b for b in jio.DataLoader(_JStream(), batch_size=3)]
        _same_tree(got, want)
        with pytest.raises(TypeError):
            len(tio.DataLoader(_Stream()))

    def test_unported_parts_raise(self):
        x, y = _data()
        with pytest.raises(NotImplementedError, match="A5"):
            tio.DataLoader(tio.TensorDataset([x, y]), num_workers=2)
        with pytest.raises(NotImplementedError, match="A3"):
            tio.DistributedBatchSampler(tio.TensorDataset([x, y]), 2)
        with pytest.raises(NotImplementedError, match="A5"):
            tio.DeviceLoader([])


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _scores(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class TestMetrics:
    @pytest.mark.parametrize("topk", [1, (1, 3)])
    @pytest.mark.parametrize("layout", ["index", "column", "onehot", "seq"])
    def test_accuracy(self, topk, layout):
        rng = np.random.RandomState(1)
        if layout == "seq":
            pred = _scores((2, 5, 6))
            label = rng.randint(0, 6, (2, 5))
        else:
            pred = _scores((8, 6))
            label = rng.randint(0, 6, (8,))
            if layout == "column":
                label = label[:, None]
            elif layout == "onehot":
                label = np.eye(6, dtype=np.float32)[label]
        jm, tm = jmetric.Accuracy(topk), tmetric.Accuracy(topk)
        for _ in range(2):
            jc = jm.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
            tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
            np.testing.assert_array_equal(tc.numpy(), _np(jc))
            assert tm.update(tc) == jm.update(jc)
        assert tm.accumulate() == jm.accumulate()
        assert tm.name() == jm.name()
        tm.reset()
        assert tm.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])

    @pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
    def test_binary(self, cls):
        rng = np.random.RandomState(3)
        jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        for i in range(3):
            preds = rng.rand(16).astype(np.float32)
            if cls == "Auc" and i == 1:
                preds = np.stack([1 - preds, preds], 1)
            labels = rng.randint(0, 2, (16,))
            jm.update(preds, labels)
            tm.update(torch.from_numpy(preds), labels)
        assert tm.accumulate() == jm.accumulate()
        assert tm.name() == jm.name()
        tm.reset()
        assert tm.accumulate() == 0.0

    def test_compute_runs_where_the_outputs_are(self):
        pred = torch.from_numpy(_scores((4, 3)))
        out = tmetric.Accuracy().compute(pred, np.array([0, 1, 2, 0]))
        assert out.device == pred.device and out.dtype == torch.float32
        assert tmetric.Precision().compute(pred, 1) == (pred, 1)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _close_loss(got, want):
    g, w = got.detach().numpy(), _np(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=LOSS_TOL, atol=LOSS_TOL)


CE_CASES = [
    dict(), dict(reduction="sum"), dict(reduction="none"),
    dict(ignore_index=2), dict(ignore_index=2, reduction="none"),
    dict(weight=True), dict(weight=True, ignore_index=1),
    dict(label_smoothing=0.1), dict(label_smoothing=0.2, weight=True),
    dict(soft_label=True), dict(soft_label=True, label_smoothing=0.1),
    dict(soft_label=True, reduction="sum"), dict(axis=1),
    dict(use_softmax=False), dict(column=True),
]


@pytest.mark.parametrize("case", CE_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in c.items())
                              or "default" for c in CE_CASES])
def test_cross_entropy(case):
    case = dict(case)
    rng = np.random.RandomState(0)
    C = 5
    axis = case.get("axis", -1)
    logits = rng.randn(6, C).astype(np.float32)
    if axis == 1:
        logits = rng.randn(2, C, 3).astype(np.float32)
    if not case.get("use_softmax", True):
        e = np.exp(logits)
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if case.pop("soft_label", False):
        label = rng.rand(*logits.shape).astype(np.float32)
        label /= label.sum(axis, keepdims=True)
        case["soft_label"] = True
    elif axis == 1:
        label = rng.randint(0, C, (2, 1, 3))
    else:
        label = rng.randint(0, C, (6,))
    if case.pop("column", False):
        label = label[:, None]
    if case.pop("weight", False):
        case["weight"] = rng.rand(C).astype(np.float32) + 0.5
    jw = dict(case)
    if "weight" in jw:
        jw["weight"] = paddle.to_tensor(jw["weight"])
    want = jnn.CrossEntropyLoss(**jw)(paddle.to_tensor(logits),
                                      paddle.to_tensor(label))
    got = tnn.CrossEntropyLoss(**case)(torch.from_numpy(logits),
                                       torch.from_numpy(label))
    _close_loss(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("cls", ["MSELoss", "L1Loss"])
def test_regression_losses(cls, reduction):
    a, b = _scores((4, 3), 1), _scores((4, 3), 2)
    want = getattr(jnn, cls)(reduction)(paddle.to_tensor(a),
                                        paddle.to_tensor(b))
    got = getattr(tnn, cls)(reduction)(torch.from_numpy(a),
                                       torch.from_numpy(b))
    _close_loss(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(reduction="sum"),
                                dict(reduction="none"), dict(ignore_index=1),
                                dict(weight=True), dict(spatial=True)])
def test_nll_loss(kw):
    kw = dict(kw)
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 4).astype(np.float32)
    label = rng.randint(0, 4, (6,))
    if kw.pop("spatial", False):
        logits = rng.randn(2, 4, 3).astype(np.float32)
        label = rng.randint(0, 4, (2, 3))
    logp = (logits - np.log(np.exp(logits).sum(1, keepdims=True))) \
        .astype(np.float32)
    if kw.pop("weight", False):
        kw["weight"] = rng.rand(4).astype(np.float32) + 0.5
    jkw = {k: (paddle.to_tensor(v) if k == "weight" else v)
           for k, v in kw.items()}
    want = jnn.NLLLoss(**jkw)(paddle.to_tensor(logp), paddle.to_tensor(label))
    got = tnn.NLLLoss(**kw)(torch.from_numpy(logp), torch.from_numpy(label))
    _close_loss(got, want)


def test_cross_entropy_is_one_recorded_op():
    static.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 5], "float32")
            y = static.data("y", [4], "int64")
            w = torch.ones(5)
            loss = tnn.CrossEntropyLoss(weight=w, label_smoothing=0.1)(x, y)
        names = [op.type for op in main.global_block().ops]
    finally:
        static.disable_static()
    assert names == ["cross_entropy"], names
    assert loss.shape == ()
