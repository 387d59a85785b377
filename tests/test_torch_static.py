"""The port's static-graph frontend (paddle_tpu_torch.static) against the
JAX package's (paddle_tpu.static) on the same programs, and the tiny
BERT recorded, fused and trained as a static Program in both.

The same numpy inputs and weights go to both packages.  On the CPU the
port's Programs run the plain PyTorch versions of the kernels (its
``fused_linear`` op included); the JAX Programs run XLA (its
``fuse_linear_act`` lowers to XLA off the TPU).  Tolerances (f32, the
two frameworks sum in different orders): outputs, losses and the
losses of AdamW steps 1e-5; gradients 1e-5 of their largest entry, and
the tiny BERT's gradients 1e-4 of their largest entry (a 2-layer
encoder's sums); weights after AdamW steps 1e-5.

The JAX BERT Program folds the position-embedding lookup into a
constant while recording (ROADMAP §C), so that table gets no gradient
or update there: its gradient is held against the JAX eager model, and
the training comparison leaves it out of the port's optimizer.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu_torch import static
from paddle_tpu_torch.convert import bert_from_jax
from paddle_tpu_torch.models import BertConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Linear
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-5
BERT_GRAD_TOL = 1e-4
CPU = "cpu"


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture
def static_mode():
    static.enable_static()
    paddle.enable_static()
    try:
        yield
    finally:
        paddle.disable_static()
        static.disable_static()


def jax_run(main, feed, fetch, startup=None):
    exe = jstatic.Executor()
    if startup is not None:
        exe.run(startup)
    return exe.run(main, feed=feed, fetch_list=fetch)


# ---------------------------------------------------------------------
# the basics (tests/test_static.py's TestStaticBasics, minus control flow)
# ---------------------------------------------------------------------
class TestStaticBasics:
    def test_record_and_run(self, static_mode):
        xv = np.random.RandomState(0).rand(3, 4).astype(np.float32)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 4], "float32")
            y = torch.matmul(x, x.transpose(0, 1)) + torch.tensor(1.0)
        assert isinstance(y, static.Variable)
        (out,) = static.Executor(CPU).run(main, feed={"x": xv},
                                          fetch_list=[y])
        jmain = jstatic.Program()
        with jstatic.program_guard(jmain):
            jx = jstatic.data("x", [None, 4], "float32")
            jy = paddle.ops.add(paddle.ops.matmul(
                jx, paddle.ops.transpose(jx, [1, 0])), paddle.to_tensor(1.0))
        close(out, xv @ xv.T + 1.0)
        close(out, jax_run(jmain, {"x": xv}, [jy])[0])

    def test_constant_folding_stays_eager(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            a = torch.tensor([1.0, 2.0])
            b = a + a
        assert not isinstance(b, static.Variable)
        assert main.global_block().ops == []
        close(b.numpy(), [2.0, 4.0])

    def test_metadata_is_not_recorded(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 3, 5], "float32")
            assert x.shape == (1, 3, 5) and x.dim() == 3
            assert x.dtype == torch.float32 and x.shape[-1] == 5
        assert main.global_block().ops == []

    def test_batch_size_agnostic(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 2], "float32")
            y = (x * 2.0).sum()
        exe = static.Executor(CPU)
        for n in (1, 5):
            (out,) = exe.run(main, feed={"x": np.ones((n, 2), np.float32)},
                             fetch_list=[y])
            assert float(out) == pytest.approx(4.0 * n)
        with pytest.raises(ValueError, match="declares"):
            exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                    fetch_list=[y])

    def test_fc_layer_and_startup(self, static_mode):
        rng = np.random.RandomState(1)
        w0 = rng.randn(3, 5).astype(np.float32)       # Paddle's [in, out]
        xv = rng.rand(2, 3).astype(np.float32) - 0.5
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [None, 3], "float32")
            h = static.nn.fc(x, 5, activation="relu", weight_attr=w0.T,
                             device=CPU)
        exe = static.Executor(CPU)
        exe.run(startup)
        (out,) = exe.run(main, feed={"x": xv}, fetch_list=[h])
        jmain, jstartup = jstatic.Program(), jstatic.Program()
        with jstatic.program_guard(jmain, jstartup):
            jx = jstatic.data("x", [None, 3], "float32")
            jh = jstatic.nn.fc(jx, 5, activation="relu",
                               weight_attr=paddle.nn.initializer.Assign(w0))
        assert out.shape == (2, 5) and (out >= 0).all()
        close(out, jax_run(jmain, {"x": xv}, [jh], jstartup)[0])

    def test_static_nn_embedding_layer_norm_dropout(self, static_mode):
        rng = np.random.RandomState(6)
        table = rng.randn(10, 8).astype(np.float32)
        ids = rng.randint(0, 10, (3, 4))
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("ids", [None, 4], "int64")
            h = static.nn.embedding(x, [10, 8], param_attr=table, device=CPU)
            h = static.nn.layer_norm(h, begin_norm_axis=2, device=CPU)
            out = static.nn.dropout(h, 0.5, is_test=True)
        exe = static.Executor(CPU)
        exe.run(startup)
        (got,) = exe.run(main, feed={"ids": ids}, fetch_list=[out])
        jmain, jstartup = jstatic.Program(), jstatic.Program()
        with jstatic.program_guard(jmain, jstartup):
            jx = jstatic.data("ids", [None, 4], "int32")
            jh = jstatic.nn.embedding(
                jx, [10, 8], param_attr=paddle.nn.initializer.Assign(table))
            jh = jstatic.nn.layer_norm(jh, begin_norm_axis=2)
            jout = jstatic.nn.dropout(jh, 0.5, is_test=True)
        close(got, jax_run(jmain, {"ids": ids.astype(np.int32)}, [jout],
                           jstartup)[0])

    def test_writeback_op_updates_live_state(self, static_mode):
        state = torch.zeros(())
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [3], "float32")
            (new,) = static.record_writeback_op(
                "accumulate", lambda s, v: s + v.sum(), [state, x], [state])
        feed = {"x": np.ones(3, np.float32)}
        exe = static.Executor(CPU)
        exe.run(main, feed=feed)
        (fetched,) = exe.run(main, feed=feed, fetch_list=[new])
        assert float(state) == 6.0 and float(fetched) == 6.0
        # a clone for test prunes state writes
        exe.run(main.clone(for_test=True), feed=feed)
        assert float(state) == 6.0

    def test_startup_reinitializes_in_place(self, static_mode):
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            w = static.create_parameter([2, 2], "float32", name="w",
                                        initializer=np.ones((2, 2)),
                                        device=CPU)
        with torch.no_grad():
            w.add_(5.0)
        static.Executor(CPU).run(startup)
        close(w.detach().numpy(), np.ones((2, 2)))
        assert w.name == "w"

    def test_append_backward(self, static_mode):
        xv = np.random.RandomState(2).rand(4, 3).astype(np.float32)
        w0 = np.random.RandomState(3).rand(3, 1).astype(np.float32)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 3], "float32")
            w = static.create_parameter([3, 1], "float32", initializer=w0,
                                        device=CPU)
            loss = torch.matmul(x, w).mean()
            pgs = static.append_backward(loss)
        assert len(pgs) == 1 and pgs[0][0] is w
        (g,) = static.Executor(CPU).run(main, feed={"x": xv},
                                        fetch_list=[pgs[0][1]])
        jmain = jstatic.Program()
        with jstatic.program_guard(jmain):
            jx = jstatic.data("x", [None, 3], "float32")
            jw = jstatic.create_parameter(
                [3, 1], "float32",
                initializer=paddle.nn.initializer.Assign(w0))
            jloss = paddle.ops.mean(paddle.ops.matmul(jx, jw))
            jpgs = jstatic.append_backward(jloss)
        close(g, xv.mean(0, keepdims=True).T)
        close(g, jax_run(jmain, {"x": xv}, [jpgs[0][1]])[0])

    def test_gradients_multi_target(self, static_mode):
        xv = np.array([1.0, 2.0], np.float32)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            (g,) = static.gradients([(x * x).sum(), (3.0 * x).sum()], x)
        (gv,) = static.Executor(CPU).run(main, feed={"x": xv},
                                         fetch_list=[g])
        jmain = jstatic.Program()
        with jstatic.program_guard(jmain):
            jx = jstatic.data("x", [2], "float32")
            (jg,) = jstatic.gradients(
                [paddle.ops.sum(jx * jx), paddle.ops.sum(3.0 * jx)], jx)
        close(gv, 2 * xv + 3.0)
        close(gv, jax_run(jmain, {"x": xv}, [jg])[0])

    def test_gradients_with_cotangent(self, static_mode):
        xv = np.array([1.0, 2.0], np.float32)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            (g,) = static.gradients(x * x, x,
                                    target_gradients=torch.tensor([1., 10.]))
        (gv,) = static.Executor(CPU).run(main, feed={"x": xv},
                                         fetch_list=[g])
        jmain = jstatic.Program()
        with jstatic.program_guard(jmain):
            jx = jstatic.data("x", [2], "float32")
            (jg,) = jstatic.gradients(
                jx * jx, jx, target_gradients=paddle.to_tensor([1.0, 10.0]))
        close(gv, 2 * xv * np.array([1.0, 10.0]))
        close(gv, jax_run(jmain, {"x": xv}, [jg])[0])

    def test_gradients_wrt_input_and_unused(self, static_mode):
        xv = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            z = static.data("z", [2], "float32")
            gx, gz = static.gradients((x * x).sum(), [x, z])
        gxv, gzv = static.Executor(CPU).run(
            main, feed={"x": xv, "z": np.ones(2, np.float32)},
            fetch_list=[gx, gz])
        jmain = jstatic.Program()
        with jstatic.program_guard(jmain):
            jx = jstatic.data("x", [2, 2], "float32")
            (jgx,) = jstatic.gradients(paddle.ops.sum(jx * jx), jx)
        close(gxv, 2 * xv)
        close(gxv, jax_run(jmain, {"x": xv}, [jgx])[0])
        close(gzv, np.zeros(2))

    def test_clone_for_test_prunes_training_ops(self, static_mode):
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [None, 3], "float32")
            t = static.data("t", [None, 1], "float32")
            w = static.create_parameter([3, 1], "float32", device=CPU)
            pred = torch.matmul(x, w)
            loss = (pred - t).square().mean()
            AdamW(0.1).minimize(loss)
        test_prog = main.clone(for_test=True)
        w_before = w.detach().clone()
        # no label feed needed, and the parameters do not move
        (p,) = static.Executor(CPU).run(
            test_prog, feed={"x": np.ones((2, 3), np.float32)},
            fetch_list=[pred])
        assert p.shape == (2, 1)
        assert torch.equal(w_before, w.detach())
        with pytest.raises(ValueError, match="missing required input"):
            static.Executor(CPU).run(
                main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[loss])

    def test_executor_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            static.Executor()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            static.create_parameter([2], "float32")

    @pytest.mark.parametrize("fn", [static.cond, static.while_loop,
                                    static.switch_case, static.Scope,
                                    static.save_inference_model,
                                    static.load_inference_model])
    def test_later_items_raise(self, fn):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()


class TestRecorderRefuses:
    def test_in_place_ops(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2, 3], "float32")
            with pytest.raises(ValueError, match="in-place op 'add_'"):
                x.add_(1.0)
            with pytest.raises(ValueError, match="in-place op"):
                x += 1.0
            with pytest.raises(ValueError, match="in-place op 'setitem'"):
                x[0] = 1.0
            with pytest.raises(ValueError, match="in-place"):
                torch.add(x, 1.0, out=torch.empty(2, 3))
        assert main.global_block().ops == []

    def test_stale_parameter_derived_const(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2, 3], "float32")
            w = static.create_parameter([4, 3], "float32", device=CPU)
            wt = w.t()              # concrete, computed from w now
            with pytest.raises(ValueError, match="'matmul' reads a concrete "
                                                 "tensor computed from a "
                                                 "parameter"):
                torch.matmul(x, wt)
            # the parameter itself is read live at every run
            y = F.linear(x, w)
        assert [op.type for op in main.global_block().ops] == ["linear"]
        assert y.shape == (2, 4)


# ---------------------------------------------------------------------
# training (tests/test_static.py's TestStaticTraining)
# ---------------------------------------------------------------------
def _regression_data(n_steps):
    rng = np.random.RandomState(0)
    true_w = rng.rand(3, 1).astype(np.float32)
    w0 = rng.rand(3, 1).astype(np.float32)
    xs = [rng.rand(16, 3).astype(np.float32) for _ in range(n_steps)]
    return w0, [(x, x @ true_w) for x in xs]


class TestStaticTraining:
    def test_adamw_regression_matches_jax(self, static_mode):
        w0, batches = _regression_data(30)
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [None, 3], "float32")
            t = static.data("t", [None, 1], "float32")
            w = static.create_parameter([3, 1], "float32", name="w",
                                        initializer=w0, device=CPU)
            loss = (torch.matmul(x, w) - t).square().mean()
            AdamW(learning_rate=0.1).minimize(loss)
        jmain, jstartup = jstatic.Program(), jstatic.Program()
        with jstatic.program_guard(jmain, jstartup):
            jx = jstatic.data("x", [None, 3], "float32")
            jt = jstatic.data("t", [None, 1], "float32")
            jw = jstatic.create_parameter(
                [3, 1], "float32", name="w",
                initializer=paddle.nn.initializer.Assign(w0))
            jloss = paddle.ops.mean(paddle.ops.square(
                paddle.ops.matmul(jx, jw) - jt))
            paddle.optimizer.AdamW(learning_rate=0.1).minimize(jloss)
        exe, jexe = static.Executor(CPU), jstatic.Executor()
        exe.run(startup)
        jexe.run(jstartup)
        losses, jlosses = [], []
        for xv, tv in batches:
            feed = {"x": xv, "t": tv}
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]))
            jlosses.append(float(jexe.run(jmain, feed=feed,
                                          fetch_list=[jloss])[0]))
        close(losses, jlosses)
        close(w.detach().numpy(), np.asarray(jw._value))
        assert losses[-1] < losses[0] * 0.2

    def test_static_matches_dygraph(self, static_mode):
        w0, batches = _regression_data(3)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 3], "float32")
            t = static.data("t", [None, 1], "float32")
            w = static.create_parameter([3, 1], "float32", initializer=w0,
                                        device=CPU)
            loss = (torch.matmul(x, w) - t).square().mean()
            AdamW(learning_rate=0.1).minimize(loss)
        exe = static.Executor(CPU)
        static_losses = [float(exe.run(main, feed={"x": xv, "t": tv},
                                       fetch_list=[loss])[0])
                         for xv, tv in batches]
        static.disable_static()
        wd = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = AdamW(learning_rate=0.1, parameters=[wd])
        eager_losses = []
        for xv, tv in batches:
            lt = (torch.from_numpy(xv) @ wd - torch.from_numpy(tv)) \
                .square().mean()
            opt.minimize(lt)
            opt.clear_grad()
            eager_losses.append(float(lt.detach()))
        static.enable_static()
        close(static_losses, eager_losses)
        close(w.detach().numpy(), wd.detach().numpy())

    def test_dygraph_without_parameters_raises(self):
        # only a static loss lets the optimizer find its parameters; a
        # dygraph step or minimize without them would update nothing
        w = torch.nn.Parameter(torch.ones(3))
        loss = (w * 2.0).sum()
        opt = AdamW(learning_rate=0.1)
        with pytest.raises(ValueError, match="without parameters"):
            opt.minimize(loss)
        assert w.grad is None                 # refused before backward
        loss.backward()
        with pytest.raises(ValueError, match="without parameters"):
            opt.step()
        assert opt._step_count == 0
        assert torch.equal(w.detach(), torch.ones(3))


# ---------------------------------------------------------------------
# passes (tests/test_static.py's TestPasses)
# ---------------------------------------------------------------------
class TestPasses:
    def test_fuse_linear_act_rewrites_and_matches(self, static_mode):
        xv = np.random.RandomState(4).randn(4, 16).astype(np.float32)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 16], "float32")
            lin = Linear(16, 32, device=CPU,
                         init=torch.Generator().manual_seed(0), init_std=0.3)
            out = F.gelu(lin(x))
        exe = static.Executor(CPU)
        (ref,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
        assert static.apply_pass(main, "fuse_linear_act") == 1
        types = [op.type for op in main.global_block().ops]
        assert types == ["fused_linear"]
        (got,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
        close(got, ref)

    @pytest.mark.parametrize("act", ["relu", "silu", "swish"])
    def test_fuses_each_activation(self, static_mode, act):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            getattr(F, act)(Linear(8, 8, device=CPU)(x))
        assert static.apply_pass(main, "fuse_linear_act") == 1

    def test_tanh_gelu_is_not_fused(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            F.gelu(Linear(8, 8, device=CPU)(x), approximate=True)
        assert [op.type for op in main.global_block().ops] == \
            ["linear", "gelu_tanh"]
        assert static.apply_pass(main, "fuse_linear_act") == 0

    def test_fuse_skips_multi_consumer(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            h = Linear(8, 8, device=CPU)(x)
            F.gelu(h)
            h * 2.0                 # a second consumer
        assert static.apply_pass(main, "fuse_linear_act") == 0

    def test_fuse_respects_fetch_keep(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            h = Linear(8, 8, device=CPU)(x)
            out = F.gelu(h)
        assert static.apply_pass(main, "fuse_linear_act", keep=[h.name]) == 0
        res = static.Executor(CPU).run(
            main, feed={"x": np.ones((4, 8), np.float32)},
            fetch_list=[h, out])
        assert len(res) == 2

    def test_eliminate_dead_ops(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2, 4], "float32")
            live = torch.tanh(x)
            dead = torch.exp(x)         # never consumed
            torch.sqrt(dead)            # a consumer of dead only
        n_before = len(main.global_block().ops)
        assert static.apply_pass(main, "eliminate_dead_ops",
                                 keep=[live.name]) == 2
        assert len(main.global_block().ops) == n_before - 2
        (out,) = static.Executor(CPU).run(
            main, feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[live])
        close(out, np.tanh(np.ones((2, 4))))

    def test_registry(self):
        assert {"fuse_linear_act", "eliminate_dead_ops"} <= \
            set(static.list_passes())
        with pytest.raises(KeyError):
            static.get_pass("nonexistent_pass")

    def test_build_strategy_preserves_outputs(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2, 4], "float32")
            out = torch.tanh(x)
        # without keep: dead-op elimination skipped, program intact
        static.apply_build_strategy(main)
        assert len(main.global_block().ops) == 1
        static.apply_build_strategy(main, keep=[out.name])
        assert len(main.global_block().ops) == 1

    def test_verification_catches_a_broken_rewrite(self, static_mode):
        from paddle_tpu_torch.static.passes import ProgramVerificationError

        @static.register_pass("test_drop_first_op")
        def drop_first(block, keep=()):
            del block.ops[0]
            return 1

        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2, 4], "float32")
            torch.exp(torch.tanh(x))
        with pytest.raises(ProgramVerificationError, match="before any op"):
            static.apply_pass(main, "test_drop_first_op")


# ---------------------------------------------------------------------
# the slice as a whole: tiny BERT
# ---------------------------------------------------------------------
B, T = 2, 16
TINY = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
POSITIONS = "bert.embeddings.position_embeddings.weight"


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (B, T))
    labels = np.where(rng.rand(B, T) < 0.3, rng.randint(0, 256, (B, T)),
                      -100)
    mask = np.ones((B, T), np.float32)
    mask[1, -5:] = 0.0              # the second sequence is padded
    labels[1, -5:] = -100
    return {"ids": ids.astype(np.int64), "labels": labels.astype(np.int64),
            "mask": mask}


def _jax_model():
    paddle.seed(0)
    return JaxBert(JaxBertConfig.tiny(**TINY))


def _named(jmodel):
    return {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}


def _jax_record(jmodel):
    main = jstatic.Program()
    with jstatic.program_guard(main):
        ids = jstatic.data("ids", [B, T], "int32")
        labels = jstatic.data("labels", [B, T], "int64")
        mask = jstatic.data("mask", [B, T], "float32")
        loss, _, _ = jmodel(ids, attention_mask=mask,
                            masked_lm_labels=labels)
    return main, loss


def _port_record(model):
    main = static.Program()
    with static.program_guard(main):
        ids = static.data("ids", [B, T], "int64")
        labels = static.data("labels", [B, T], "int64")
        mask = static.data("mask", [B, T], "float32")
        loss, _, _ = model(ids, attention_mask=mask, masked_lm_labels=labels)
    return main, loss


def _jax_feed(feed):
    return {**feed, "ids": feed["ids"].astype(np.int32)}


@pytest.fixture(scope="module")
def jax_bert():
    """The JAX side, run once: the static loss and gradients on one
    batch, the eager gradients, and 3 AdamW steps of a Program fused
    before ``minimize`` (the JAX executor cannot run one fused after)."""
    feed = _batch(0)
    jmodel = _jax_model()
    named = _named(jmodel)
    names = {id(p): n for n, p in jmodel.named_parameters()}
    paddle.enable_static()
    try:
        main, loss = _jax_record(jmodel)
        pgs = jstatic.append_backward(loss)
        out = jax_run(main, _jax_feed(feed), [loss] + [g for _, g in pgs])
        grads = {names[id(p)]: np.asarray(g) for (p, _), g in
                 zip(pgs, out[1:])}
        tmodel = _jax_model()
        tmain, tloss = _jax_record(tmodel)
        fused = jstatic.apply_pass(tmain, "fuse_linear_act")
        paddle.optimizer.AdamW(1e-3, parameters=tmodel.parameters()) \
            .minimize(tloss)
        exe = jstatic.Executor()
        step_losses = [float(exe.run(tmain, feed=_jax_feed(_batch(1)),
                                     fetch_list=[tloss])[0])
                       for _ in range(3)]
    finally:
        paddle.disable_static()
    jl, _, _ = jmodel(paddle.to_tensor(feed["ids"].astype(np.int32)),
                      attention_mask=paddle.to_tensor(feed["mask"]),
                      masked_lm_labels=paddle.to_tensor(
                          feed["labels"].astype(np.int32)))
    jl.backward()
    eager = {n: np.asarray(p.grad.numpy())
             for n, p in jmodel.named_parameters() if p.grad is not None}
    return dict(named=named, feed=feed, loss=float(out[0]), grads=grads,
                eager_grads=eager, fused=fused, step_losses=step_losses,
                trained=_named(tmodel))


def _port_model(jax_bert):
    return bert_from_jax(jax_bert["named"], BertConfig.tiny(**TINY),
                         device=CPU)


def _hold_grads(got, want, tol=BERT_GRAD_TOL):
    # plus 1e-6 absolute for a gradient that cancels to zero (the key
    # projection's bias: the softmax ignores a shift common to all keys)
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        assert err <= tol * float(np.abs(w).max()) + 1e-6, (name, err)


def _port_adamw(model, trainable):
    return AdamW(1e-3, parameters=[(n, p) for n, p in model.named_parameters()
                                   if trainable(n)])


def _port_train(jax_bert, fuse_after_minimize, trainable):
    model = _port_model(jax_bert)
    main, loss = _port_record(model)
    if not fuse_after_minimize:
        assert static.apply_pass(main, "fuse_linear_act") == 3
    _port_adamw(model, trainable).minimize(loss)
    if fuse_after_minimize:
        assert static.apply_pass(main, "fuse_linear_act") == 3
    exe = static.Executor(CPU)
    losses = [float(exe.run(main, feed=_batch(1), fetch_list=[loss])[0])
              for _ in range(3)]
    return model, main, losses


def test_sequence_classification_matches_jax():
    from paddle_tpu.models.bert import BertForSequenceClassification as JC

    from paddle_tpu_torch.models import BertForSequenceClassification

    paddle.seed(0)
    jmodel = JC(JaxBertConfig.tiny(**TINY), num_classes=3)
    named = _named(jmodel)
    model = BertForSequenceClassification(BertConfig.tiny(**TINY), 3,
                                          device=CPU, seed=None)
    linear = {n + ".weight" for n, m in model.named_modules()
              if isinstance(m, Linear)}
    assert set(named) == {n for n, _ in model.named_parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = torch.from_numpy(np.array(named[name]))
            p.copy_(src.t() if name in linear else src)
    feed, labels = _batch(0), np.array([0, 2])
    jloss, jlogits = jmodel(
        paddle.to_tensor(feed["ids"].astype(np.int32)),
        attention_mask=paddle.to_tensor(feed["mask"]),
        labels=paddle.to_tensor(labels.astype(np.int32)))
    loss, logits = model(torch.from_numpy(feed["ids"]),
                         attention_mask=torch.from_numpy(feed["mask"]),
                         labels=torch.from_numpy(labels))
    close(logits.detach().numpy(), np.asarray(jlogits.numpy()))
    close(float(loss.detach()), float(jloss.numpy()))


class TestTinyBert:
    def test_loss_and_every_gradient_match_jax(self, static_mode, jax_bert):
        model = _port_model(jax_bert)
        names = {id(p): n for n, p in model.named_parameters()}
        main, loss = _port_record(model)
        pgs = static.append_backward(loss)
        out = static.Executor(CPU).run(main, feed=jax_bert["feed"],
                                       fetch_list=[loss]
                                       + [g for _, g in pgs])
        close(out[0], jax_bert["loss"])
        got = {names[id(p)]: g for (p, _), g in zip(pgs, out[1:])}
        assert set(got) - set(jax_bert["grads"]) == {POSITIONS}
        linear = {n + ".weight" for n, m in model.named_modules()
                  if isinstance(m, Linear)}
        got = {n: g.T if n in linear else g for n, g in got.items()}
        _hold_grads(got, jax_bert["grads"])
        # the position table, which the JAX Program folds, against the
        # JAX eager model
        _hold_grads(got, {POSITIONS: jax_bert["eager_grads"][POSITIONS]})

    def test_both_fuse_three_pairs(self, static_mode, jax_bert):
        assert jax_bert["fused"] == 3
        main, loss = _port_record(_port_model(jax_bert))
        assert static.apply_build_strategy(main, keep=[loss.name]) > 3
        types = [op.type for op in main.global_block().ops]
        assert types.count("fused_linear") == 3 and "gelu" not in types

    @pytest.mark.parametrize("fuse_after_minimize", [False, True])
    def test_three_adamw_steps_match_jax(self, static_mode, jax_bert,
                                         fuse_after_minimize):
        model, main, losses = _port_train(
            jax_bert, fuse_after_minimize, lambda n: n != POSITIONS)
        close(losses, jax_bert["step_losses"])
        assert losses[-1] < losses[0]
        linear = {n + ".weight" for n, m in model.named_modules()
                  if isinstance(m, Linear)}
        for name, p in model.named_parameters():
            got = p.detach().numpy()
            if name == POSITIONS:     # trained by neither (see docstring)
                close(got, jax_bert["named"][name])
                continue
            if name.endswith("k_proj.bias"):
                # its gradient is roundoff (the softmax ignores a shift
                # common to all keys), which AdamW normalizes into steps
                # of +-lr by its sign in either package; the losses
                # above show it changes nothing
                continue
            np.testing.assert_allclose(
                got.T if name in linear else got, jax_bert["trained"][name],
                rtol=TOL, atol=TOL, err_msg=name)

    def test_eager_matches_static(self, static_mode, jax_bert):
        _, _, static_losses = _port_train(jax_bert, True, lambda n: True)
        static.disable_static()
        try:
            model = _port_model(jax_bert)
            opt = _port_adamw(model, lambda n: True)
            eager_losses = []
            feed = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
            for _ in range(3):
                loss, _, _ = model(feed["ids"], attention_mask=feed["mask"],
                                   masked_lm_labels=feed["labels"])
                opt.minimize(loss)
                opt.clear_grad()
                eager_losses.append(float(loss.detach()))
        finally:
            static.enable_static()
        close(static_losses, eager_losses)


# ---------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------
class TestDropout:
    def test_same_seed_same_mask(self):
        x = torch.ones(64, 64)
        a = F.dropout(x, 0.25, True, torch.Generator().manual_seed(5))
        b = F.dropout(x, 0.25, True, torch.Generator().manual_seed(5))
        c = F.dropout(x, 0.25, True, torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_keep_rate_and_scaling(self):
        # n = 2^20 draws: the kept share's standard deviation is
        # sqrt(p (1 - p) / n) = 4.2e-4 at p = 0.1; 6 of them bound it
        p, n = 0.1, 1 << 20
        out = F.dropout(torch.ones(n), p, True,
                        torch.Generator().manual_seed(0))
        kept = out != 0
        assert abs(float(kept.float().mean()) - (1 - p)) <= \
            6 * (p * (1 - p) / n) ** 0.5
        assert torch.all(out[kept] == 1.0 / (1.0 - p))

    def test_identity_when_off(self):
        x = torch.randn(8)
        assert F.dropout(x, 0.5, False) is x and F.dropout(x, 0.0) is x

    def test_downscale_in_infer_keeps_values(self):
        out = F.dropout(torch.ones(1024), 0.5, True,
                        torch.Generator().manual_seed(2),
                        mode="downscale_in_infer")
        assert set(out.unique().tolist()) == {0.0, 1.0}
        with pytest.raises(ValueError, match="dropout mode"):
            F.dropout(torch.ones(4), 0.5, True, mode="other")

    def test_recorded_program_draws_at_every_run(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [256], "float32")
            y = F.dropout(x, 0.5, True, torch.Generator().manual_seed(1))
        exe = static.Executor(CPU)
        feed = {"x": np.ones(256, np.float32)}
        (a,), (b,) = (exe.run(main, feed=feed, fetch_list=[y])
                      for _ in range(2))
        assert not np.array_equal(a, b)
        assert set(np.unique(a)) <= {0.0, 2.0}
