"""Pipeline parallelism of paddle_tpu_torch against the JAX package, on
the CPU: two gloo worlds (4 and 8 ranks, one process a rank, the port's
launcher through ``torch_mesh_world`` running
``tests/torch_pipeline_ranks.py``), the JAX side on the conftest's 8
virtual CPU devices, the same numpy inputs and weights (carried by
``convert.py``) on both.  f32 throughout.  The cases are those of
``tests/test_distributed.py``'s ``TestPipeline``, ``Test1F1B`` and
``TestTPxPP``:

- ``gpipe_spmd`` at pp 4: each rank's output of the last stage against
  the JAX one within 1e-6 (the same f32 products, one rank a stage).
- The generic stage of ``Test1F1B::test_generic_parity_vs_sequential``
  (S = 4, M = 6) under 1F1B and GPipe: the loss (rtol 1e-6), each
  rank's stage gradients and the shared ones against the JAX
  ``pipeline_1f1b`` and ``jax.value_and_grad`` of the sequential loss
  within 1e-6 absolute (the JAX test's own).
- The tiny Llama through ``llama_1f1b_step_fn``: pp 2 over 10 SGD steps
  against the JAX step and the JAX eager model (atol, rtol 1e-5: the
  JAX test's); pp 2 x dp 2 against the JAX run of the same mesh
  (loss rtol 1e-5, gradients atol 1e-5: flash attention's plain
  version sums in another order than the JAX reference attention);
  a tied-embedding Llama at pp 4 through the step and through
  ``LlamaForCausalLMPipe`` (the table a ``SharedLayerDesc`` of the
  first and last stage) against the JAX step (the same tolerances).
- ``fleet.distributed_model`` + ``train_batch`` on pp 2 x dp 4 of the
  generic model, 5 SGD steps, against the JAX eager microbatch loop
  (losses and final weights within 1e-5, the JAX test's), and pp 2 x
  mp 2 x dp 2 of the pipe Llama with AdamW against the JAX run of the
  same mesh (losses rtol 1e-4: AdamW divides by the square root of
  small second moments, which magnifies the f32 ordering differences).
- The schedules' record of microbatches in flight (at most S - s on
  stage s under 1F1B, M under GPipe: the CPU form of the memory
  claim), their hops against ``schedule_p2p_calls``, and the same loss
  and gradients from both, bit for bit.
- ``ClipGradByGlobalNorm`` at half the gradients' norm over one
  ``train_batch`` of the tied pipe (4 layers) on pp 2 x dp 2 and pp 2 x
  mp 2: every stage clips by the whole model's norm, the table shared
  by the first and last stage counted once, as the JAX model's single
  table is; the norm and the loss within 1e-5 relative, each update
  within 1e-4 of its largest entry against the JAX unsharded step.
- The refusals: a ``scaler``, a batch that does not divide into M
  microbatches, a plain module on a pp mesh, pp with ZeRO.
"""
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy
from paddle_tpu.distributed.pipeline import (PipelineLayer as JPipelineLayer,
                                             PipelineParallel as
                                             JPipelineParallel,
                                             gpipe_spmd as jgpipe,
                                             pipeline_1f1b as j1f1b)
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama_pp import LlamaForCausalLMPipe as JPipe
from paddle_tpu.models.llama_pp import (extract_pipeline_params,
                                        llama_1f1b_step_fn as jstep_fn)

from torch_mesh_world import ROOT, result, run_world

RANKS = ROOT / "tests" / "torch_pipeline_ranks.py"
CASES4 = ("pp_gpipe", "pp_generic", "pp_llama_dp", "pp_tied",
          "pp_schedules", "pp_refusals", "pp_opt_state", "pp_clip")
CASES8 = ("pp_llama_steps", "pp_fleet_generic", "pp_tpxpp")
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            dtype="float32")
TPXPP = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=32,
             dtype="float32")
LLAMA_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t)


def _jcfg(d, **kw):
    return JLlamaConfig(**{**d, **kw}, use_flash_attention=False)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _llama_params(cfg, S):
    paddle.seed(0)
    shared, stacked = extract_pipeline_params(JLlama(cfg))
    L = cfg.num_hidden_layers
    stacked_S = jax.tree_util.tree_map(
        lambda x: x.reshape((S, L // S) + x.shape[1:]), stacked)
    return shared, stacked, stacked_S


def _on_mesh(axes, fn):
    n = int(np.prod(list(axes.values())))
    mesh = jmesh.init_mesh(axes, devices=jax.devices()[:n])
    try:
        return fn(mesh)
    finally:
        jmesh._GLOBAL_MESH = None
        jmesh._GLOBAL_HCG = None


def _gpipe():
    rng = np.random.RandomState(0)
    Ws = rng.randn(4, 2, 8, 8).astype(np.float32) * 0.5
    Bs = rng.randn(4, 2, 8).astype(np.float32) * 0.1
    x = rng.randn(6, 2, 8).astype(np.float32)

    def stage_fn(params, h):
        def body(hh, wb):
            return jnp.tanh(hh @ wb[0] + wb[1]), None
        return jax.lax.scan(body, h, params)[0]

    yield dict(Ws=Ws, Bs=Bs, x=x)
    yield np.asarray(_on_mesh({"pp": 4}, lambda m: jgpipe(
        stage_fn, (jnp.asarray(Ws), jnp.asarray(Bs)), jnp.asarray(x),
        mesh=m)))


def _generic():
    S, L, d, M, micro, T = 4, 2, 8, 6, 2, 3
    rng = np.random.RandomState(0)
    Ws = rng.randn(S, L, d, d).astype(np.float32) * 0.5
    emb = rng.randn(16, d).astype(np.float32) * 0.5
    head = rng.randn(d, 16).astype(np.float32) * 0.5
    tokens = rng.randint(0, 16, (M, micro, T)).astype(np.int32)
    labels = rng.randint(0, 16, (M, micro, T)).astype(np.int32)

    def body(local_W, h):
        return jax.lax.scan(lambda hh, w: (jnp.tanh(hh @ w), None), h,
                            local_W)[0]

    def loss_fn(hw, h, lab):
        logp = jax.nn.log_softmax(h @ hw, -1)
        return -jnp.mean(jnp.take_along_axis(logp, lab[..., None],
                                             -1)[..., 0])

    def stage_fn(stage, shared, local, x, mb_in, mb_tgt):
        h = jax.lax.cond(stage == 0, lambda: shared["emb"][mb_in],
                         lambda: x)
        h = body(local, h)
        loss = jax.lax.cond(stage == S - 1,
                            lambda: loss_fn(shared["head"], h, mb_tgt),
                            lambda: jnp.float32(0.0))
        return h, loss

    yield dict(Ws=Ws, emb=emb, head=head, tokens=tokens, labels=labels,
               act_shape=(micro, T, d))
    shared = {"emb": jnp.asarray(emb), "head": jnp.asarray(head)}
    loss, gW, gsh = _on_mesh({"pp": S}, lambda m: jax.jit(
        lambda *a: j1f1b(stage_fn, *a, mesh=m))(
            jnp.asarray(Ws), shared, jnp.asarray(tokens),
            jnp.asarray(labels), jnp.zeros((micro, T, d), jnp.float32)))

    def ref_loss(Ws, shared):
        tot = 0.0
        for m in range(M):
            h = shared["emb"][tokens[m]]
            for s in range(S):
                h = body(Ws[s], h)
            tot = tot + loss_fn(shared["head"], h, labels[m])
        return tot / M

    rl, (rgW, rgsh) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(Ws), shared)
    yield dict(loss=float(loss), gW=_np(gW), gsh=_tree(gsh),
               ref_loss=float(rl), ref_gW=_np(rgW), ref_gsh=_tree(rgsh))


def _llama_dp():
    cfg = _jcfg(TINY)
    B, T, M, S = 8, 16, 2, 2
    tok = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    shared, _, stacked_S = _llama_params(cfg, S)
    mb = jnp.asarray(tok).reshape(M, B // M, T)
    yield dict(cfg=TINY, shared=_tree(shared), stacked_S=_tree(stacked_S),
               mb=np.asarray(mb))
    out = {}
    for tag, axes, axis in (("pp", {"pp": S}, None),
                            ("hybrid", {"pp": S, "dp": 2}, "dp")):
        loss, g_st, g_sh = _on_mesh(axes, lambda m: jax.jit(jstep_fn(
            cfg, m, M, B // M, T, data_axis=axis))(shared, stacked_S, mb,
                                                    mb))
        out[tag] = dict(loss=float(loss), g_st=_tree(g_st), g_sh=_tree(g_sh))
    yield out


def _llama_steps():
    cfg = _jcfg(TINY)
    B, T, M, steps, lr = 4, 16, 2, 10, 0.1
    rng = np.random.RandomState(0)
    data = [rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
            for _ in range(steps)]
    shared, _, stacked_S = _llama_params(cfg, 2)
    yield dict(cfg=TINY, shared=_tree(shared), stacked_S=_tree(stacked_S),
               data=data, M=M, lr=lr)
    paddle.seed(0)
    model = JLlama(cfg)
    eager = []
    for tok in data:
        t = paddle.to_tensor(tok)
        loss, _ = model(t, labels=t)
        loss.backward()
        eager.append(float(loss.numpy()))
        for p in model.parameters():
            if p.grad is not None:
                p.set_value(p._value - lr * p.grad._value)
        model.clear_gradients()

    def run(mesh):
        step = jax.jit(jstep_fn(cfg, mesh, M, B // M, T))
        sh, st, losses = shared, stacked_S, []
        for tok in data:
            mb = jnp.asarray(tok).reshape(M, B // M, T)
            loss, g_st, g_sh = step(sh, st, mb, mb)
            losses.append(float(loss))
            sh = jax.tree_util.tree_map(lambda p, g: p - lr * g, sh, g_sh)
            st = jax.tree_util.tree_map(lambda p, g: p - lr * g, st, g_st)
        return losses

    yield dict(eager=eager, pp=_on_mesh({"pp": 2}, run))


def _tied():
    d = dict(TINY, num_hidden_layers=4, tie_word_embeddings=True)
    cfg = _jcfg(d)
    S, M, micro, T = 4, 2, 2, 16
    shared, stacked, stacked_S = _llama_params(cfg, S)
    mb = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (M, micro, T)).astype(np.int32)
    yield dict(cfg=d, shared=_tree(shared), stacked=_tree(stacked),
               stacked_S=_tree(stacked_S), mb=mb)
    loss, g_st, g_sh = _on_mesh({"pp": S}, lambda m: jax.jit(jstep_fn(
        cfg, m, M, micro, T))(shared, stacked_S, jnp.asarray(mb),
                              jnp.asarray(mb)))
    yield dict(loss=float(loss), g_st=_tree(g_st), g_sh=_tree(g_sh))


def _fleet_generic():
    vocab, d, nblocks = 16, 8, 4
    B, T, M, steps, lr = 8, 6, 2, 5, 0.1

    class _Block(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(d, d)

        def forward(self, x):
            return paddle.tanh(self.fc(x))

    def loss_fn(out, lab):
        return jnn.functional.cross_entropy(out.reshape([-1, vocab]),
                                            lab.reshape([-1]))

    rng = np.random.RandomState(0)
    data = [rng.randint(0, vocab, (B, T)).astype(np.int32)
            for _ in range(steps)]
    paddle.seed(0)
    ref = JPipelineLayer([jnn.Embedding(vocab, d)]
                         + [_Block() for _ in range(nblocks)]
                         + [jnn.Linear(d, vocab)], num_stages=1,
                         loss_fn=loss_fn)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    yield dict(vocab=vocab, d=d, M=M, lr=lr, data=data, state=state)
    opt = paddle.optimizer.SGD(lr, parameters=ref.parameters())
    losses = []
    for tok in data:
        total = 0.0
        for m in range(M):
            mx = paddle.to_tensor(tok[m * (B // M):(m + 1) * (B // M)])
            loss = loss_fn(ref(mx), mx) / M
            loss.backward()
            total += float(loss.numpy())
        opt.step()
        opt.clear_grad()
        losses.append(total)
    final = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    yield dict(losses=losses, final=final)


def _tpxpp():
    cfg = _jcfg(TPXPP)
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2, "mp_degree": 2,
                               "dp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": 2}

    def pipe():
        jfleet.init(is_collective=True, strategy=strategy)
        np.random.seed(0)
        return JPipe(cfg, num_stages=2)

    try:
        state = {k: np.asarray(v.numpy()).copy()
                 for k, v in pipe().state_dict().items()}
    finally:
        jmesh._GLOBAL_MESH = None
        jmesh._GLOBAL_HCG = None
    rng = np.random.RandomState(42)
    data = [rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
            for _ in range(3)]
    yield dict(cfg=TPXPP, state=state, data=data)
    try:
        pl = pipe()                    # the same draws: the state above
        pl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
        model = jfleet.distributed_model(pl)
        if not isinstance(model, JPipelineParallel):   # as TestTPxPP runs it
            model = JPipelineParallel(pl, None, strategy)
        opt = jfleet.distributed_optimizer(
            paddle.optimizer.AdamW(1e-3, parameters=pl.parameters()))
        losses = [float(np.asarray(model.train_batch(
            (paddle.to_tensor(t), paddle.to_tensor(t)), opt).numpy()))
            for t in data]
        compiled = model._1f1b is not None and not model._1f1b_failed
    finally:
        jmesh._GLOBAL_MESH = None
        jmesh._GLOBAL_HCG = None
    yield dict(losses=losses, compiled=compiled)


def _opt_state():
    """The JAX pipe (4 layers, one process) after one AdamW step of its
    microbatch loop: weights and optimizer state; then its second
    step."""
    d = dict(TINY, num_hidden_layers=4)
    cfg = _jcfg(d)
    strategy = DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": 2}
    paddle.seed(0)
    pl = JPipe(cfg, num_stages=1)
    model = JPipelineParallel(pl, None, strategy)
    opt = paddle.optimizer.AdamW(1e-3, parameters=pl.parameters())
    rng = np.random.RandomState(5)
    data = [rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
            for _ in range(2)]
    t = paddle.to_tensor(data[0])
    model.train_batch((t, t), opt)
    yield dict(cfg=d, state={k: np.asarray(v.numpy())
                             for k, v in pl.state_dict().items()},
               names=[n for n, _ in pl.named_parameters()],
               opt={k: (np.asarray(v.numpy()) if hasattr(v, "numpy")
                        else v) for k, v in opt.state_dict().items()},
               batch=data[1])
    t = paddle.to_tensor(data[1])
    loss = float(np.asarray(model.train_batch((t, t), opt).numpy()))
    yield dict(loss=loss, final={k: np.asarray(v.numpy())
                                 for k, v in pl.state_dict().items()})


def _clip():
    """The tied tiny Llama (4 layers) unsharded, one SGD step on [4, 16]
    under ClipGradByGlobalNorm at half the gradients' global norm: the
    initial weights and the final ones under the pipe's names, the
    norm, the loss."""
    from paddle_tpu_torch.convert import pipeline_named
    from paddle_tpu_torch.models import LlamaConfig

    d = dict(TINY, num_hidden_layers=4, tie_word_embeddings=True)
    cfg = _jcfg(d)
    lr = 0.1
    ids = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (4, 16)).astype(np.int64)

    def named(model):
        return _tree(pipeline_named(*extract_pipeline_params(model),
                                    LlamaConfig(**d)))

    paddle.seed(0)
    model = JLlama(cfg)
    t = paddle.to_tensor(ids)
    loss, _ = model(t, labels=t)
    loss.backward()
    norm = float(np.sqrt(sum(float((np.asarray(p.grad.numpy(),
                                               np.float64) ** 2).sum())
                             for p in model.parameters())))
    model.clear_gradients()
    clip = norm / 2
    init = named(model)
    yield dict(cfg=d, init=init, ids=ids, clip=clip, lr=lr)
    opt = paddle.optimizer.SGD(lr, parameters=model.parameters(),
                               grad_clip=jnn.ClipGradByGlobalNorm(clip))
    loss, _ = model(t, labels=t)
    loss.backward()
    opt.step()
    yield dict(norm=norm, loss=float(loss.numpy()), final=named(model),
               init=init)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Each case's inputs, then (while the two worlds run the port's
    side in a thread) the JAX package's results; ``worlds`` joins the
    thread."""
    sides = {"pp_gpipe": _gpipe(), "pp_generic": _generic(),
             "pp_llama_dp": _llama_dp(), "pp_llama_steps": _llama_steps(),
             "pp_tied": _tied(), "pp_fleet_generic": _fleet_generic(),
             "pp_tpxpp": _tpxpp(), "pp_opt_state": _opt_state(),
             "pp_clip": _clip()}
    inputs = {name: next(gen) for name, gen in sides.items()}
    rng = np.random.RandomState(3)
    inputs["pp_schedules"] = dict(
        cfg=dict(TINY, num_hidden_layers=4),
        ids=rng.randint(0, 256, (6, 8)).astype(np.int64))
    inputs["pp_refusals"] = dict(cfg=dict(TINY, num_hidden_layers=4))
    tmp = [tmp_path_factory.mktemp(f"pp_world{n}") for n in (4, 8)]
    worlds = {}

    def run():
        worlds[4] = run_world(4, inputs, CASES4, tmp[0], ranks=RANKS)
        worlds[8] = run_world(8, inputs, CASES8, tmp[1], ranks=RANKS)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    out = {name: next(gen) for name, gen in sides.items()}
    out["thread"], out["worlds"] = thread, worlds
    return out


def _world(jax_side, n):
    jax_side["thread"].join()
    return jax_side["worlds"][n]


@pytest.fixture(scope="module")
def world4(jax_side):
    return _world(jax_side, 4)


@pytest.fixture(scope="module")
def world8(jax_side):
    return _world(jax_side, 8)


class TestPipeline:
    def test_gpipe_spmd_exact(self, world4, jax_side):
        want = jax_side["pp_gpipe"]
        for out in result(world4, "pp_gpipe"):
            np.testing.assert_allclose(out, want, atol=1e-6)

    def test_pipeline_layer_api(self):
        import torch

        from paddle_tpu_torch.distributed.pipeline import (LayerDesc,
                                                           PipelineLayer)

        pl = PipelineLayer([LayerDesc(torch.nn.Linear, 8, 8)
                            for _ in range(4)], num_stages=2)
        out = pl(torch.rand(2, 8))
        assert tuple(out.shape) == (2, 8)
        assert len(pl.get_stage_layers(0)) == 2
        assert [n.split(".")[0] for n, _ in pl.named_parameters()] == \
            ["0", "0", "1", "1", "2", "2", "3", "3"]

    def test_placement_beside_segment_uniform(self):
        # the compiled placement (prologue with stage 0, the body evenly,
        # the epilogue with the last stage) where the reference's
        # get_stage_layers answers with segment_uniform
        from paddle_tpu_torch.distributed.layers_helper import \
            segment_uniform
        from paddle_tpu_torch.distributed.pipeline import stage_segments
        from paddle_tpu_torch.models import LlamaConfig
        from paddle_tpu_torch.models.llama_pp import LlamaForCausalLMPipe

        pl = LlamaForCausalLMPipe(LlamaConfig.tiny(num_hidden_layers=8),
                                  device="cpu")
        assert stage_segments(pl._entries, 4) == \
            [(0, 3), (3, 5), (5, 7), (7, 10)]
        assert segment_uniform(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
        with pytest.raises(ValueError, match="homogeneous body"):
            stage_segments(pl._entries, 16)


class Test1F1B:
    @pytest.mark.parametrize("schedule", ["1F1B", "FThenB"])
    def test_generic_parity_vs_sequential(self, world4, jax_side, schedule):
        want = jax_side["pp_generic"]
        for s, res in enumerate(result(world4, "pp_generic")):
            got = res[schedule]
            for loss in (want["loss"], want["ref_loss"]):
                np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
            for gW in (want["gW"], want["ref_gW"]):
                np.testing.assert_allclose(got["g_local"], gW[s], atol=1e-6)
            for gsh in (want["gsh"], want["ref_gsh"]):
                for k in ("emb", "head"):
                    np.testing.assert_allclose(got["g_shared"][k], gsh[k],
                                               atol=1e-6, err_msg=k)
            assert got["counts"] == got["want"] and got["staged"] == {}

    def test_llama_pp2_matches_pp1_10_steps(self, world8, jax_side):
        want = jax_side["pp_llama_steps"]
        rs = result(world8, "pp_llama_steps")
        for losses in rs:
            assert losses == rs[0]
        np.testing.assert_allclose(rs[0], want["pp"], **LLAMA_TOL)
        np.testing.assert_allclose(rs[0], want["eager"], **LLAMA_TOL)

    def test_llama_pp2_dp2_composition(self, world4, jax_side):
        want = jax_side["pp_llama_dp"]
        for res in result(world4, "pp_llama_dp"):
            for tag in ("pp", "hybrid"):
                got, ref = res[tag], want[tag]
                s = got["stage"]
                np.testing.assert_allclose(got["loss"], ref["loss"],
                                           rtol=1e-5)
                for k, g in got["g_st"].items():
                    np.testing.assert_allclose(g, ref["g_st"][k][s],
                                               atol=1e-5, err_msg=k)
                for k, g in got["g_sh"].items():
                    np.testing.assert_allclose(g, ref["g_sh"][k], atol=1e-5,
                                               err_msg=k)
            np.testing.assert_allclose(res["hybrid"]["loss"],
                                       res["pp"]["loss"], rtol=1e-6)

    def test_tied_embedding_llama(self, world4, jax_side):
        want = jax_side["pp_tied"]
        L = 4
        for res in result(world4, "pp_tied"):
            s = res["stage"]
            for loss in (res["loss"], res["module"]["loss"]):
                np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
            for k, g in res["g_st"].items():
                np.testing.assert_allclose(g, want["g_st"][k][s], **LLAMA_TOL)
            for k, g in res["g_sh"].items():
                np.testing.assert_allclose(g, want["g_sh"][k], **LLAMA_TOL)
            grads = res["module"]["grads"]
            # the table lives on the first and the last stage alone
            assert ("shared_layers.embed.embed_tokens.weight" in grads) == \
                (s in (0, 3))
            if s in (0, 3):
                np.testing.assert_allclose(
                    grads["shared_layers.embed.embed_tokens.weight"],
                    want["g_sh"]["embed"], **LLAMA_TOL)
            if s == 3:
                np.testing.assert_allclose(grads[f"{L + 1}.norm.weight"],
                                           want["g_sh"]["norm"], **LLAMA_TOL)
            layer = s + 1
            np.testing.assert_allclose(
                grads[f"{layer}.layer.self_attn.q_proj.weight"],
                want["g_st"]["q"][s][0], **LLAMA_TOL)

    def test_schedules_in_flight_and_hops(self, world4):
        # 1F1B holds at most S - s microbatches' graphs on stage s, GPipe
        # all M; both make the hops of schedule_p2p_calls (M activations
        # each way across every boundary) and give the same loss and
        # gradients bit for bit
        for res in result(world4, "pp_schedules"):
            a, b = res["1F1B"], res["FThenB"]
            s = a["stage"]
            assert a["in_flight"] == min(4 - s, 6)
            assert b["in_flight"] == 6
            for got in (a, b):
                assert got["counts"] == got["want"] and got["staged"] == {}
            assert a["loss"] == b["loss"]
            for n in a["names"]:
                np.testing.assert_array_equal(a["grads"][n], b["grads"][n])
            held = {n.split(".")[0] for n in a["names"]}
            assert held == [{"0", "1"}, {"2"}, {"3"}, {"4", "5"}][s]

    def test_fleet_train_batch_compiled_1f1b_generic(self, world8,
                                                     jax_side):
        want = jax_side["pp_fleet_generic"]
        rs = result(world8, "pp_fleet_generic")
        final = {}
        for res in rs:
            assert res["wrapped"] == "PipelineParallel"
            assert res["segments"] == [(0, 3), (3, 6)]
            np.testing.assert_allclose(res["losses"], want["losses"],
                                       atol=1e-5, rtol=1e-5)
            final.update(res["final"])
        assert sorted(final) == sorted(want["final"])
        for name, w in want["final"].items():
            np.testing.assert_allclose(final[name], w, atol=1e-5,
                                       err_msg=name)


class TestOptimizerState:
    def test_jax_adamw_state_carried_into_each_stage(self, world4,
                                                     jax_side):
        # each stage takes its own parameters' slots of the JAX state
        # (held_only) and its second step matches the JAX pipe's
        want = jax_side["pp_opt_state"]
        final = {}
        for res in result(world4, "pp_opt_state"):
            np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)
            assert res["slots"] == 2 * len(res["final"])
            final.update(res["final"])
        assert sorted(final) == sorted(want["final"])
        for name, w in want["final"].items():
            np.testing.assert_allclose(final[name], w, **LLAMA_TOL,
                                       err_msg=name)


class TestTPxPP:
    def test_pp2_mp2_dp2_matches_pp1_mp1(self, world8, jax_side):
        want = jax_side["pp_tpxpp"]
        assert want["compiled"]
        rs = result(world8, "pp_tpxpp")
        for res in rs:
            assert res["wrapped"] == "PipelineParallel"
            assert res["losses"] == rs[0]["losses"]
            # the stage's projections, table and head are mp parts
            assert res["split"] and all(".norm" not in n and "layernorm"
                                        not in n for n in res["split"])
        np.testing.assert_allclose(rs[0]["losses"], want["losses"],
                                   rtol=1e-4)
        assert rs[0]["losses"][-1] < rs[0]["losses"][0]


class TestGlobalNormClip:
    @pytest.mark.parametrize("degrees", [("pp",), ("pp", "mp")])
    def test_clip_takes_the_whole_models_norm(self, world4, jax_side,
                                              degrees):
        """Every stage clips by the norm of the whole model (the tied
        table counted once), so the clipped SGD step equals the JAX
        unsharded one: the norm within 1e-5 relative, each parameter's
        update within 1e-4 of its largest entry (the f32 sums over the
        ranks round in another order than XLA's)."""
        want = jax_side["pp_clip"]
        init = want["init"]
        held = set()
        for res in result(world4, "pp_clip"):
            got = res[degrees]
            np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            for name, w in got["final"].items():
                d_want = want["final"][name] - init[name]
                np.testing.assert_allclose(
                    w - init[name], d_want, rtol=0,
                    atol=1e-4 * float(np.abs(d_want).max()), err_msg=name)
                held.add(name)
        assert held == set(want["final"])


class TestRefusals:
    @pytest.mark.parametrize("key,kind,word", [
        ("scaler", "NotImplementedError", "A5"),
        ("indivisible", "ValueError", "not divisible by accumulate_steps"),
        ("plain", "NotImplementedError", "PipelineLayer"),
        ("sharding", "NotImplementedError", "sharding")])
    def test_refused_on_a_pp_mesh(self, world4, key, kind, word):
        for res in result(world4, "pp_refusals"):
            assert res["wrapped"] == "PipelineParallel"
            assert res[key] is not None and res[key][0] == kind, res[key]
            assert word in res[key][1]
