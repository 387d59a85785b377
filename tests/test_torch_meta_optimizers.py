"""Fleet's meta-optimizers in paddle_tpu_torch against the JAX package's
(``paddle_tpu/distributed/fleet/meta_optimizers.py``), on the CPU.

In this process, the cases of the reference's own tests
(``tests/test_distributed.py``: ``TestMetaOptimizers``,
``TestDGCStrategyWiring``, ``TestGradientMerge``,
``TestGradientMergeEdgeCases``), each run through both packages on the
same numpy inputs: local SGD's sync steps, DGC's sparsification and
error feedback (exact), DGC momentum over many steps (each weight within
1e-5 of the JAX run's), gradient merge against the JAX wrapper and
against one step on the concatenated batch, the strategy wiring and its
warnings, a parameter whose gradient comes in one microstep only, and
the step count of real updates.

Across ranks, one world of 4 (gloo, ``tests/torch_tp_ranks.py``): the
tied tiny f32 Llama through fleet ``{"dp": 2, "mp": 2}`` (the table and
the projections split over mp), 3 steps of the model's fused loss under
each meta-optimizer alone and in the reference's combinations, against
the JAX package's optimizers and wrappers on the unsharded model:

- ``dgc`` (Momentum becomes DGCMomentum; rampup 1, sparsity 0.9),
  ``lars`` (Momentum becomes LarsMomentum) and ``gradient_merge`` (k 2,
  over SGD) see the data ranks' mean gradient, so they are held against
  the JAX optimizer fed the global batch: the mean of the two data
  ranks' losses within 1e-5 relative, each weight's update within 1e-4
  of its largest entry.  Gradient merge averages over the data ranks on
  the apply step alone, over the merged sum; in f32 the mean of sums and
  the sum of means agree within these bounds.  The world's runs take
  SGD and Momentum, whose updates follow the gradient's size: AdamW
  moves a weight by about its learning rate whatever its gradient's
  size, so the last bits of a gradient near 0 would decide a move
  (gradient merge over AdamW is held in this process, against the JAX
  wrapper).
- ``localsgd`` (k 2, begin 1; alone over SGD, with gradient merge, and
  with dgc and gradient merge over Momentum) is true local SGD
  here: each rank is held against the JAX ``LocalSGDOptimizer`` fed
  that rank's rows, the two replicas' parameters averaged (numpy) at
  its sync steps, where the reference's single controller averages
  nothing.  Each rank's loss a step and its final weights, with the
  bounds above.
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import meta_optimizers as tmeta
from torch_mesh_world import ROOT, result, run_world

RANKS = ROOT / "tests" / "torch_tp_ranks.py"
SEQ, BATCH, STEPS = 16, 4, 3
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=SEQ, dtype="float32", lm_loss_chunk=8,
           tie_word_embeddings=True, fused_lm_loss=True)
DGC = {"rampup_begin_step": 1, "sparsity": 0.9}
GM = {"k_steps": 2, "avg": True}
LOCAL = {"k_steps": 2, "begin_step": 1}
LARS = {"lars_coeff": 0.001, "lars_weight_decay": 0.0005}
RUNS = {
    "dgc": dict(meta={"dgc": DGC}, base="momentum", lr=0.05),
    "lars": dict(meta={"lars": LARS}, base="momentum", lr=0.5),
    "gradient_merge": dict(meta={"gradient_merge": GM}, base="sgd",
                           lr=0.1),
    "localsgd": dict(meta={"localsgd": LOCAL}, base="sgd", lr=0.1),
    "gm_localsgd": dict(meta={"gradient_merge": GM, "localsgd": LOCAL},
                        base="sgd", lr=0.1),
    "dgc_gm_localsgd": dict(meta={"dgc": DGC, "gradient_merge": GM,
                                  "localsgd": LOCAL},
                            base="momentum", lr=0.05),
}
CHAINS = {"dgc": ["DGCMomentum"], "lars": ["LarsMomentum"],
          "gradient_merge": ["GradientMergeOptimizer", "SGD"],
          "localsgd": ["LocalSGDOptimizer", "SGD"],
          "gm_localsgd": ["LocalSGDOptimizer", "GradientMergeOptimizer",
                          "SGD"],
          "dgc_gm_localsgd": ["LocalSGDOptimizer", "GradientMergeOptimizer",
                              "DGCMomentum"]}
LOSS_RTOL = 1e-5
REL = 1e-4                       # of an update's largest entry


def r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tparam(a):
    return torch.nn.Parameter(torch.from_numpy(np.array(a)))


def _jparam(a):
    w = paddle.to_tensor(np.array(a))
    w.stop_gradient = False
    return w


# --------------------------------------------- the reference's own cases
class TestLocalSGD:
    def test_steps_and_syncs(self):
        """Step 1 (before begin_step 2) syncs, then every 4th from 2: the
        same sync steps as the JAX wrapper."""
        syncs = {}
        for pkg in ("jax", "torch"):
            if pkg == "jax":
                w = _jparam(r(4, 3))
                opt = jfleet.LocalSGDOptimizer(
                    paddle.optimizer.SGD(0.1, parameters=[w]), k_steps=4,
                    begin_step=2)
            else:
                w = _tparam(r(4, 3))
                opt = tmeta.LocalSGDOptimizer(
                    pt.optimizer.SGD(0.1, parameters=[w]), k_steps=4,
                    begin_step=2)
            got = syncs.setdefault(pkg, [])
            opt._average_parameters = lambda o=opt, g=got: g.append(
                o._step_count)
            for _ in range(10):
                (w ** 2).sum().backward()
                opt.step()
                opt.clear_grad()
        assert syncs["torch"] == syncs["jax"] == [1, 2, 6, 10]

    def test_via_strategy(self):
        s = tfleet.DistributedStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": 3, "begin_step": 1}
        tfleet.init(is_collective=True, strategy=s)
        try:
            w = _tparam(r(2, 2))
            opt = tfleet.distributed_optimizer(
                pt.optimizer.SGD(0.1, parameters=[w]))
            assert isinstance(opt, tmeta.LocalSGDOptimizer)
            assert opt.k_steps == 3
            (w ** 2).sum().backward()
            opt.step()
            opt.clear_grad()
        finally:
            tfleet.shutdown()


class TestDGC:
    def test_sparsify_error_feedback_exact(self):
        g = np.array([[1.0, 0.1], [0.2, 3.0]], np.float32)
        want = jmeta._dgc_sparsify(jnp.asarray(g), jnp.zeros((2, 2)), 1)
        got = tmeta.dgc_sparsify(torch.from_numpy(g), torch.zeros(2, 2), 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        again = tmeta.dgc_sparsify(torch.zeros(2, 2), got[1], 1)[0]
        np.testing.assert_array_equal(again.numpy(), [[1.0, 0], [0, 0]])

    def test_momentum_correction_exact(self):
        rng = np.random.RandomState(3)
        g, u, v = (rng.randn(6, 5).astype(np.float32) for _ in range(3))
        want = [np.asarray(x) for x in jmeta._dgc_momentum_correction(
            jnp.asarray(g), jnp.asarray(u), jnp.asarray(v), 0.9, 7)]
        tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
        sparse = tmeta.dgc_momentum_correction(torch.from_numpy(g), tu, tv,
                                               0.9, 7)
        for a, b in zip((sparse, tu, tv), want):
            np.testing.assert_array_equal(a.numpy(), b)
        assert int((sparse != 0).sum()) == 7

    def test_momentum_sparsifies_and_converges(self):
        """800 steps at 90 % sparsity reach the target, as the JAX
        test's, and every weight stays within 1e-5 of the JAX run's."""
        target = r(8, 8)
        finals = {}
        for pkg in ("jax", "torch"):
            if pkg == "jax":
                w = _jparam(np.zeros((8, 8), np.float32))
                opt = jfleet.DGCMomentum(learning_rate=0.01, momentum=0.9,
                                         parameters=[w], sparsity=0.9)
                tgt = paddle.to_tensor(target)
            else:
                w = _tparam(np.zeros((8, 8), np.float32))
                opt = tmeta.DGCMomentum(learning_rate=0.01, momentum=0.9,
                                        parameters=[w], sparsity=0.9)
                tgt = torch.from_numpy(target)
            for _ in range(800):
                ((w - tgt) ** 2).sum().backward()
                opt.step()
                opt.clear_grad()
            finals[pkg] = np.asarray(w.detach().numpy() if pkg == "torch"
                                     else w.numpy())
        np.testing.assert_allclose(finals["torch"], target, atol=0.05)
        np.testing.assert_allclose(finals["torch"], finals["jax"], atol=1e-5)

    def test_via_strategy(self):
        s = tfleet.DistributedStrategy()
        s.dgc = True
        s.dgc_configs = {"rampup_begin_step": 2, "sparsity": 0.5}
        tfleet.init(is_collective=True, strategy=s)
        try:
            w = _tparam(r(4, 4))
            opt = tfleet.distributed_optimizer(
                pt.optimizer.Momentum(0.01, momentum=0.9, parameters=[w]))
            assert isinstance(opt, tmeta.DGCMomentum)
            assert opt.rampup_begin_step == 2
            for _ in range(4):
                (w ** 2).sum().backward()
                opt.step()
                opt.clear_grad()
            assert opt._dgc_step == 4
        finally:
            tfleet.shutdown()

    @pytest.mark.parametrize("flag", ["dgc", "lars"])
    def test_ignored_for_adamw(self, flag):
        s = tfleet.DistributedStrategy()
        setattr(s, flag, True)
        tfleet.init(is_collective=True, strategy=s)
        try:
            w = _tparam(r(2, 2))
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                opt = tfleet.distributed_optimizer(
                    pt.optimizer.AdamW(1e-3, parameters=[w]))
            assert any(flag in str(x.message) for x in rec)
            assert type(opt) is pt.optimizer.AdamW
        finally:
            tfleet.shutdown()

    def test_lars_swaps_a_plain_momentum(self):
        s = tfleet.DistributedStrategy()
        s.lars = True
        s.lars_configs = dict(LARS)
        tfleet.init(is_collective=True, strategy=s)
        try:
            w = _tparam(r(2, 2))
            opt = tfleet.distributed_optimizer(pt.optimizer.Momentum(
                0.1, momentum=0.8, parameters=[("w", w)]))
            assert type(opt) is pt.optimizer.LarsMomentum
            assert opt._momentum == 0.8 and opt._lars_coeff == 0.001
            assert opt._param_name(w) == "w"
        finally:
            tfleet.shutdown()


def _data(steps=4):
    rng = np.random.RandomState(5)
    return [(rng.rand(8, 16).astype(np.float32),
             rng.randint(0, 4, (8,)).astype(np.int64)) for _ in range(steps)]


def _jnet():
    paddle.seed(11)
    return jnn.Sequential(jnn.Linear(16, 32), jnn.Tanh(), jnn.Linear(32, 4))


def _tnet(jnet):
    """The port's [in, out] copy of the JAX net's weights."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            w = [np.asarray(p.numpy()) for p in jnet.parameters()]
            self.w0, self.b0, self.w1, self.b1 = (_tparam(a) for a in w)

        def forward(self, x):
            return torch.tanh(x @ self.w0 + self.b0) @ self.w1 + self.b1

    return Net()


def _jloss(net, x, y):
    return jnn.functional.cross_entropy(net(paddle.to_tensor(x)),
                                        paddle.to_tensor(y))


def _tloss(net, x, y):
    return torch.nn.functional.cross_entropy(net(torch.from_numpy(x)),
                                             torch.from_numpy(y))


class TestGradientMerge:
    def test_matches_the_jax_wrapper_and_the_full_batch(self):
        data = _data()
        jnet = _jnet()
        tnet = _tnet(jnet)
        ref = _tnet(jnet)
        jopt = jmeta.GradientMergeOptimizer(
            paddle.optimizer.AdamW(1e-2, parameters=jnet.parameters()),
            k_steps=2, avg=True)
        topt = tmeta.GradientMergeOptimizer(
            pt.optimizer.AdamW(1e-2, parameters=tnet.parameters()),
            k_steps=2, avg=True)
        ropt = pt.optimizer.AdamW(1e-2, parameters=ref.parameters())
        for i, (x, y) in enumerate(data):
            _jloss(jnet, x, y).backward()
            jopt.step()
            jopt.clear_grad()
            _tloss(tnet, x, y).backward()
            topt.step()
            topt.clear_grad()
            if i % 2:
                xs = np.concatenate([data[i - 1][0], x])
                ys = np.concatenate([data[i - 1][1], y])
                _tloss(ref, xs, ys).backward()
                ropt.step()
                ropt.clear_grad()
        for jp, tp, rp in zip(jnet.parameters(), tnet.parameters(),
                              ref.parameters()):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.numpy()), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(tp.detach().numpy(),
                                       rp.detach().numpy(), rtol=1e-4,
                                       atol=1e-6)
        assert topt._inner._step_count == 2

    def test_strategy_wiring(self):
        s = tfleet.DistributedStrategy()
        s.gradient_merge = True
        s.gradient_merge_configs = dict(GM)
        tfleet.init(is_collective=True, strategy=s)
        try:
            w = _tparam(r(2, 2))
            opt = tfleet.distributed_optimizer(
                pt.optimizer.AdamW(1e-2, parameters=[w]))
            assert isinstance(opt, tmeta.GradientMergeOptimizer)
            assert opt.k_steps == 2
        finally:
            tfleet.shutdown()

    def test_param_without_grad_on_apply_step_not_dropped(self):
        a, b = _tparam(r(4, 4, seed=1)), _tparam(r(4, 4, seed=2))
        opt = tmeta.GradientMergeOptimizer(
            pt.optimizer.AdamW(1e-2, parameters=[a, b]), k_steps=2,
            avg=False)
        x = torch.from_numpy(r(2, 4, seed=3))
        before = b.detach().clone()
        ((x @ a).sum() + (x @ b).sum()).backward()
        opt.step()
        opt.clear_grad()
        (x @ a).sum().backward()
        opt.step()
        opt.clear_grad()
        assert not torch.equal(b.detach(), before)

    def test_step_count_matches_real_updates(self):
        w = _tparam(r(4, 4))
        opt = tmeta.GradientMergeOptimizer(
            pt.optimizer.AdamW(1e-2, parameters=[w]), k_steps=2)
        x = torch.from_numpy(r(2, 4, seed=4))
        for _ in range(4):
            (x @ w).sum().backward()
            opt.step()
            opt.clear_grad()
        assert opt._inner._step_count == 2


# ------------------------------------------------ the world: fleet on mp
def _jax_model(weights):
    net = JLlama(JLlamaConfig(**CFG, use_flash_attention=False))
    net.set_state_dict({n: paddle.to_tensor(w) for n, w in weights.items()})
    return net


def _jax_base(run, net):
    lr = run["lr"]
    meta = run["meta"]
    if run["base"] == "sgd":
        return paddle.optimizer.SGD(lr, parameters=net.parameters())
    if "dgc" in meta:
        return jfleet.DGCMomentum(learning_rate=lr, momentum=0.9,
                                  parameters=net.parameters(),
                                  **meta["dgc"])
    if "lars" in meta:
        return paddle.optimizer.LarsMomentum(
            learning_rate=lr, momentum=0.9, parameters=net.parameters(),
            **meta["lars"])
    return paddle.optimizer.Momentum(lr, momentum=0.9,
                                     parameters=net.parameters())


def _jax_run(run, weights, batches):
    """The JAX optimizers on the unsharded model: with local SGD one
    replica a data rank, fed its rows, the replicas' parameters averaged
    (numpy) at the wrapper's sync steps; else one model fed the global
    batch.  Returns ``([losses a replica], [final weights a
    replica])``."""
    local = "localsgd" in run["meta"]
    n = 2 if local else 1
    nets = [_jax_model(weights) for _ in range(n)]
    opts, synced = [], []
    for net in nets:
        opt = _jax_base(run, net)
        if "gradient_merge" in run["meta"]:
            opt = jmeta.GradientMergeOptimizer(opt, **run["meta"]
                                               ["gradient_merge"])
        if local:
            opt = jmeta.LocalSGDOptimizer(opt, **run["meta"]["localsgd"])
            opt._average_parameters = lambda: synced.append(True)
        opts.append(opt)
    losses = [[] for _ in range(n)]
    for b in batches:
        synced.clear()
        rows = b.shape[0] // n
        for i, (net, opt) in enumerate(zip(nets, opts)):
            t = paddle.to_tensor(b[i * rows:(i + 1) * rows].astype(np.int64))
            loss, _ = net(t, labels=t)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[i].append(float(loss.numpy()))
        if synced:
            params = [list(net.parameters()) for net in nets]
            for ps in zip(*params):
                mean = np.mean([np.asarray(p.numpy()) for p in ps], axis=0)
                for p in ps:
                    p.set_value(paddle.to_tensor(mean.astype(np.float32)))
    finals = [{k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
              for net in nets]
    return losses, finals


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, CFG["vocab_size"], (BATCH, SEQ))
               .astype(np.int32) for _ in range(STEPS)]
    paddle.seed(0)
    weights = {n: np.asarray(t.numpy()) for n, t in JLlama(JLlamaConfig(
        **CFG, use_flash_attention=False)).state_dict().items()}
    inputs = {"meta": dict(cfg=CFG, weights=weights, batches=batches,
                           runs=RUNS)}
    tmp = tmp_path_factory.mktemp("meta_world")
    box = {}
    thread = threading.Thread(
        target=lambda: box.update(world=run_world(4, inputs, ("meta",), tmp,
                                                  ranks=RANKS)),
        daemon=True)
    thread.start()
    jax = {name: _jax_run(run, weights, batches)
           for name, run in RUNS.items()}
    thread.join()
    return dict(world=box["world"], jax=jax, weights=weights)


def _hold(got, want, init):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        d_got, d_want = got[name] - init[name], w - init[name]
        tol = REL * float(np.abs(d_want).max())
        np.testing.assert_allclose(d_got, d_want, rtol=0, atol=tol + 1e-12,
                                   err_msg=name)


class TestMetaOptimizersOnMp:
    @pytest.mark.parametrize("name", list(RUNS))
    def test_against_jax(self, sides, name):
        run = RUNS[name]
        losses, finals = sides["jax"][name]
        rs = result(sides["world"], "meta")
        local = "localsgd" in run["meta"]
        for res in rs:
            got = res[name]
            assert got["chain"] == CHAINS[name]
            d = got["data_rank"]
            if local:
                np.testing.assert_allclose(got["losses"], losses[d],
                                           rtol=LOSS_RTOL)
                _hold(got["final"], finals[d], sides["weights"])
            else:
                _hold(got["final"], finals[0], sides["weights"])
        if not local:
            by_rank = {}
            for res in rs:
                by_rank.setdefault(res[name]["data_rank"],
                                   res[name]["losses"])
            mean = np.mean([by_rank[0], by_rank[1]], axis=0)
            np.testing.assert_allclose(mean, losses[0], rtol=LOSS_RTOL)

    def test_localsgd_refused_with_zero(self, sides):
        for res in result(sides["world"], "meta"):
            kind, msg = res["refused"]
            assert kind == "NotImplementedError" and "sharding" in msg
