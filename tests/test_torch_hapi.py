"""The port's ``hapi.Model`` against the JAX package's: the same weights
(carried across by ``convert``), the same batches, through ``prepare``,
``fit``, ``evaluate`` and ``predict``; ``EarlyStopping`` and the
``LRScheduler`` callback; ``save`` / ``load`` and ``summary``.

A tiny f32 Llama (``LlamaConfig.tiny``) with AdamW, ``CrossEntropyLoss``
and ``Accuracy``, and a small MLP with Adam and ``MSELoss`` over a
``TensorDataset`` (the port's ``Linear`` keeps PyTorch's [out, in]
weight: the JAX [in, out] weights go across transposed).  The JAX loop
compiles its step, the port's runs eagerly on the CPU.  Tolerances
(f32, sums in different orders): each step's loss within LOSS_TOL,
every final weight within WEIGHT_TOL absolute (1 % of one step at
learning rate 1e-3: Adam divides by the root of the second moment, so
where a gradient entry is near 0 a last-place difference in it moves
the update by a share of the learning rate); metric logs within
LOSS_TOL (the top-k counts are equal).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.optimizer import lr as jlr
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import lr as tlr

LOSS_TOL = 1e-5
WEIGHT_TOL = 1e-5


class _Record:
    """Mixin: each batch's logs, in order."""

    def __init__(self):
        super().__init__()
        self.logs = []
        self.lrs = []

    def on_train_batch_end(self, step, logs=None):
        self.logs.append(dict(logs))
        self.lrs.append(self.model._optimizer.get_lr())


class JRecord(_Record, jcb.Callback):
    pass


class TRecord(_Record, tcb.Callback):
    pass


def _token_batches(n=4, b=2, t=16, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(1, 256, (b, t + 1)).astype(np.int64)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _jax_weights(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _close_weights(tnet, want, transposed=()):
    got = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].T if k in transposed else got[k]
        np.testing.assert_allclose(g, w, rtol=0, atol=WEIGHT_TOL, err_msg=k)


def _close_logs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)


def _llama_pair(lr=1e-3):
    paddle.seed(0)
    jnet = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    tnet = from_jax_state_dict(_jax_weights(jnet), LlamaConfig.tiny(),
                               device="cpu")
    jm = paddle.Model(jnet)
    jm.prepare(paddle.optimizer.AdamW(lr, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(), paddle.metric.Accuracy())
    tm = pt.Model(tnet)
    tm.prepare(pt.optimizer.AdamW(lr, parameters=tnet.parameters()),
               tnn.CrossEntropyLoss(), pt.metric.Accuracy())
    return jm, tm


def _mlp_pair(lr=0.01, jsched=None, tsched=None):
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(4, 16), jnn.ReLU(), jnn.Linear(16, 2))
    tnet = torch.nn.Sequential(tnn.Linear(4, 16, device="cpu"),
                               torch.nn.ReLU(),
                               tnn.Linear(16, 2, device="cpu"))
    with torch.no_grad():
        for k, v in _jax_weights(jnet).items():
            tnet.state_dict()[k].copy_(torch.from_numpy(np.array(
                v.T if k.endswith("weight") else v)))
    jm, tm = paddle.Model(jnet), pt.Model(tnet)
    jm.prepare(paddle.optimizer.Adam(jsched or lr,
                                     parameters=jnet.parameters()),
               jnn.MSELoss())
    tm.prepare(pt.optimizer.Adam(tsched or lr, parameters=tnet.parameters()),
               tnn.MSELoss())
    return jm, tm


def _regression(n=24, seed=1):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 2).astype(np.float32)
    x = rng.randn(n, 4).astype(np.float32)
    return x, (x @ w).astype(np.float32)


MLP_T = ("0.weight", "2.weight")


class TestFitMatchesJax:
    def test_tiny_llama_fit_evaluate_predict(self):
        jm, tm = _llama_pair()
        data = _token_batches()
        jr, tr = JRecord(), TRecord()
        jh = jm.fit(data, epochs=2, verbose=0, callbacks=[jr])
        th = tm.fit(data, epochs=2, verbose=0, callbacks=[tr])
        assert len(tr.logs) == 8 and sorted(tr.logs[0]) == ["acc", "loss"]
        _close_logs(tr.logs, jr.logs)
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        _close_weights(tm.network, _jax_weights(jm.network))
        _close_logs([tm.evaluate(data, verbose=0)],
                    [jm.evaluate(data, verbose=0)])
        tp, jp = tm.predict(data[:2]), jm.predict(data[:2])
        assert len(tp[0]) == 2
        for g, w in zip(tp[0], jp[0]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)

    def test_mlp_fit_over_a_dataset(self):
        x, y = _regression()
        jm, tm = _mlp_pair()
        jds = paddle.io.TensorDataset([x, y])
        tds = pt.io.TensorDataset([x, y])
        jr, tr = JRecord(), TRecord()
        jh = jm.fit(jds, eval_data=jds, batch_size=8, epochs=3, shuffle=False,
                    verbose=0, callbacks=[jr])
        th = tm.fit(tds, eval_data=tds, batch_size=8, epochs=3,
                    shuffle=False, verbose=0, callbacks=[tr])
        _close_logs(tr.logs, jr.logs)
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        _close_weights(tm.network, _jax_weights(jm.network), MLP_T)
        got = tm.predict(tds, batch_size=8, stack_outputs=True)[0]
        want = jm.predict(jds, batch_size=8, stack_outputs=True)[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_train_and_eval_batch(self):
        x, y = _regression(8)
        jm, tm = _mlp_pair()
        for _ in range(2):
            np.testing.assert_allclose(tm.train_batch([x], [y]),
                                       jm.train_batch([x], [y]),
                                       rtol=LOSS_TOL)
        np.testing.assert_allclose(tm.eval_batch([x], [y]),
                                   jm.eval_batch([x], [y]), rtol=LOSS_TOL)
        out = tm.predict_batch([x])
        assert not out.requires_grad and out.shape == (8, 2)

    def test_num_iters_and_stop(self):
        jm, tm = _llama_pair()
        data = _token_batches(6)
        jr, tr = JRecord(), TRecord()
        jm.fit(data, epochs=2, num_iters=2, verbose=0, callbacks=[jr])
        tm.fit(data, epochs=2, num_iters=2, verbose=0, callbacks=[tr])
        assert len(tr.logs) == len(jr.logs) == 4
        _close_logs(tr.logs, jr.logs)


class TestCallbacks:
    @pytest.mark.parametrize("kw", [dict(monitor="loss", mode="max",
                                         patience=1),
                                    dict(monitor="loss", patience=2,
                                         min_delta=10.0)])
    def test_early_stopping_at_the_same_epoch(self, kw):
        x, y = _regression()
        jm, tm = _mlp_pair()
        jds, tds = paddle.io.TensorDataset([x, y]), pt.io.TensorDataset([x, y])
        jes, tes = jcb.EarlyStopping(**kw), tcb.EarlyStopping(**kw)
        jh = jm.fit(jds, eval_data=jds, batch_size=8, epochs=6,
                    shuffle=False, verbose=0, callbacks=[jes])
        th = tm.fit(tds, eval_data=tds, batch_size=8, epochs=6,
                    shuffle=False, verbose=0, callbacks=[tes])
        assert len(th["loss"]) == len(jh["loss"]) < 6
        assert tm.stop_training and jm.stop_training
        assert tes.wait == jes.wait

    def test_lr_scheduler_callback_gives_the_same_rates(self):
        x, y = _regression()
        jsched = jlr.PiecewiseDecay([2, 5], [0.01, 0.005, 0.001])
        tsched = tlr.PiecewiseDecay([2, 5], [0.01, 0.005, 0.001])
        jm, tm = _mlp_pair(jsched=jsched, tsched=tsched)
        jr, tr = JRecord(), TRecord()
        jds, tds = paddle.io.TensorDataset([x, y]), pt.io.TensorDataset([x, y])
        jm.fit(jds, batch_size=8, epochs=3, shuffle=False, verbose=0,
               callbacks=[jr])
        tm.fit(tds, batch_size=8, epochs=3, shuffle=False, verbose=0,
               callbacks=[tr])
        assert tr.lrs == jr.lrs and len(set(tr.lrs)) == 3
        assert tsched.last_epoch == jsched.last_epoch == 9
        _close_weights(tm.network, _jax_weights(jm.network), MLP_T)

    def test_by_epoch_and_checkpoint_callbacks(self, tmp_path, capsys):
        x, y = _regression()
        sched = tlr.StepDecay(0.01, step_size=1, gamma=0.5)
        _, tm = _mlp_pair(tsched=sched)
        tds = pt.io.TensorDataset([x, y])
        tm.fit(tds, batch_size=8, epochs=2, shuffle=False, verbose=1,
               log_freq=1, save_dir=str(tmp_path),
               callbacks=[tcb.LRScheduler(by_step=False, by_epoch=True)])
        out = capsys.readouterr().out
        assert "Epoch 1/2" in out and "step 2/3 - loss:" in out
        # the fit's own by-step scheduler and the by-epoch one
        assert sched.last_epoch == 6 + 2
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
            "final.pdopt", "final.pdparams"]

    def test_visualdl_raises(self):
        with pytest.raises(NotImplementedError, match="A5"):
            tcb.VisualDL()


class TestPersistence:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_save_load_round_trips_bit_for_bit(self, tmp_path, dtype):
        cfg = LlamaConfig.tiny(dtype=dtype)
        data = _token_batches(2)
        net = LlamaForCausalLM(cfg, device="cpu", seed=0)
        model = pt.Model(net)
        model.prepare(pt.optimizer.AdamW(1e-3, parameters=net.parameters()),
                      tnn.CrossEntropyLoss())
        model.fit(data, verbose=0)
        path = str(tmp_path / "ck" / "m")
        model.save(path)
        net2 = LlamaForCausalLM(cfg, device="cpu", seed=1)
        model2 = pt.Model(net2)
        model2.prepare(pt.optimizer.AdamW(1e-3,
                                          parameters=net2.parameters()),
                       tnn.CrossEntropyLoss())
        model2.load(path)
        for (k, a), b in zip(net.state_dict().items(),
                             net2.state_dict().values()):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        s1, s2 = model._optimizer.state_dict(), model2._optimizer.state_dict()
        assert sorted(s1) == sorted(s2)
        for k, v in s1.items():
            assert torch.equal(v, s2[k]) if isinstance(v, torch.Tensor) \
                else v == s2[k]
        # and both go on the same way
        model.fit(data, verbose=0)
        model2.fit(data, verbose=0)
        for a, b in zip(net.parameters(), net2.parameters()):
            assert torch.equal(a, b)
        arrays = pt.load(path + ".pdparams", return_numpy=dtype == "float32")
        assert sorted(arrays) == sorted(net.state_dict())

    def test_reset_optimizer_and_training_false(self, tmp_path):
        _, tm = _mlp_pair()
        tm.save(str(tmp_path / "w"), training=False)
        assert not (tmp_path / "w.pdopt").exists()
        tm.load(str(tmp_path / "w"), reset_optimizer=True)


class TestSummaryAndOptions:
    def test_summary_counts_match(self, capsys):
        jm, tm = _llama_pair()
        assert tm.summary() == jm.summary()
        jm, tm = _mlp_pair()
        assert tm.summary() == jm.summary() == {"total_params": 114,
                                                "trainable_params": 114}
        assert "Total params: 114" in capsys.readouterr().out
        assert len(tm.parameters()) == 4

    @pytest.mark.parametrize("call", [
        lambda m: m.prepare(mesh={"dp": 2}), lambda m: m.use_mesh({}),
        lambda m: m.xray(None), lambda m: m.shardplan(None),
        lambda m: m.fit([], xray_on_start=True),
        lambda m: m.fit([], hbm_budget_bytes=1 << 30),
        lambda m: m.fit([], shardplan=True), lambda m: m.fit([], mesh={})])
    def test_later_slice_options_raise(self, call):
        _, tm = _mlp_pair()
        with pytest.raises(NotImplementedError, match="A3|A5"):
            call(tm)

    def test_amp_configs_taken_and_batches_follow_the_network(self):
        _, tm = _mlp_pair()
        tm.prepare(tm._optimizer, tm._loss, amp_configs={"level": "O1"})
        x, y = _regression(8)
        loss = tm.train_batch(torch.from_numpy(x), torch.from_numpy(y))
        assert isinstance(loss, float) and np.isfinite(loss)
        assert tm._on_device([x])[0].device == torch.device("cpu")
