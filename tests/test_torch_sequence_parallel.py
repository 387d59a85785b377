"""Sequence and context parallelism of paddle_tpu_torch against the JAX
package, on the CPU: one world of 8 ranks (gloo, one process a rank, the
port's launcher through ``torch_mesh_world``) for the module's cases; the
JAX side on the conftest's 8 virtual CPU devices.  f32 throughout.

- Ring attention (``kernels.ring_attention``: the flash kernels' plain
  versions per held block with the LSE merge, its own backward) and
  Ulysses (``kernels.ulysses_attention``) on an sp 8 mesh, causal and
  not, MHA with 4 and 8 heads and GQA: each rank's output and
  dq/dk/dv of ``sum(out * w)`` against its positions of the JAX global
  ones (the cases of ``tests/test_distributed.py::TestRingAttention``
  and ``TestUlyssesAttention``), within 2e-5 (outputs) and 1e-4
  (gradients) absolute, the f32 sums of the blocks and of the hops
  rounding in another order than XLA's; Ulysses with 2 kv heads at sp 8
  (its fallback to ring) and on sp 4 x tp 2 with each tp rank's heads
  (``head_axis``).  The ring's hops are counted, none staged on the CPU.
- The tiny Llama with ``context_parallel="ring"``, ``"ulysses"`` (2 kv
  heads at sp 4: the ring fallback), ``sequence_parallel=True`` and ring
  under ``recompute`` on ``{"data": 2, "sp": 4}``, and Ulysses with 8 q
  over 4 kv heads on ``{"data": 2, "tp": 2, "sp": 2}`` (each tp rank's
  local heads through the all-to-alls), through
  ``hapi.Model(mesh=...)``, 3 AdamW steps, against the JAX
  ``MeshExecutor`` on the same mesh and the JAX model unsharded: losses
  rtol 1e-4, atol 1e-5, gathered final weights rtol 1e-4, atol 1e-5
  (``tests/test_torch_expert_parallel.py``'s, for its reasons); the
  model's own shifted loss, fused and not, against the JAX model's
  (rtol 1e-5).
- The ring Llama through fleet with dp 2 x ``sep_degree`` 4: the
  model's shifted loss, the fleet step summing over sep, against the
  JAX model unsharded (the same tolerances); then a dense Llama in the
  same session, replicated over sep and trained with SGD (whose update
  shows a gradient summed over sep where AdamW's would not), against
  the JAX dense model's SGD steps.
- ``make_ring_sp_step`` against the JAX ``make_ring_sp_step`` (the case
  of ``tests/test_moe_sp_workloads.py::TestRingModelStep``): the dense
  fallback and each rank's rows on the mesh (1e-4), one cache entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.kernels.ring_attention import ring_attention as jring
from paddle_tpu.kernels.ulysses_attention import ulysses_attention as july
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.generation import make_ring_sp_step as jstep

from torch_mesh_world import result, run_world

AXES = {"data": 2, "sp": 4}
BATCH, SEQ = 4, 16
STEPS = 3
SGD_LR = 0.05
MODES = {"ring": dict(context_parallel="ring"),
         "ulysses": dict(context_parallel="ulysses"),
         "sequence_parallel": dict(sequence_parallel=True),
         "ring_recompute": dict(context_parallel="ring", recompute=True),
         # 8 q over 4 kv heads: each tp rank's 2 kv heads split over sp 2
         "ulysses_tp": dict(context_parallel="ulysses",
                            num_attention_heads=8, num_key_value_heads=4)}
#: a mode's mesh where it is not AXES, and its rank's [rows, positions]
MODE_AXES = {"ulysses_tp": {"data": 2, "tp": 2, "sp": 2}}
PARTS = {"ulysses_tp": (2, 8)}
CASES = ("sp_attention", "sp_llama", "sp_fleet", "sp_step", "sp_refusals")
OUT_TOL = dict(rtol=0, atol=2e-5)
GRAD_TOL = dict(rtol=0, atol=1e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
#: (B, T, H, KVH, D) of each attention case (tests/test_distributed.py's)
ATTN = {"mha": (2, 64, 4, 4, 16), "heads8": (2, 64, 8, 8, 16),
        "gqa": (1, 32, 8, 2, 8)}


class _LMLoss:
    def __call__(self, logits, labels):
        vocab = logits.shape[-1]
        return jnn.functional.cross_entropy(
            logits.reshape([-1, vocab]), labels.reshape([-1]))


def _named(net):
    return {n: np.asarray(t.numpy()) for n, t in net.state_dict().items()}


def _jax_attention(fn, shape, causal, mesh, spec, seed, **kw):
    """The global output and gradients of ``sum(fn(q, k, v) * w)`` with
    q, k, v placed by ``spec`` on ``mesh``, and the inputs."""
    B, T, H, KVH, D = shape
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, h, D).astype(np.float32)
               for h in (H, KVH, KVH))
    w = rng.randn(B, T, H, D).astype(np.float32)
    sh = NamedSharding(mesh, spec)

    def loss(q, k, v):
        out = fn(q, k, v, mesh=mesh, causal=causal, **kw)
        return jnp.sum(out * w), out

    args = [jax.device_put(jnp.asarray(a), sh) for a in (q, k, v)]
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return dict(q=q, k=k, v=v, w=w, causal=causal, out=np.asarray(out),
                dq=np.asarray(grads[0]), dk=np.asarray(grads[1]),
                dv=np.asarray(grads[2]))


def _attention_side():
    mesh = jmesh.init_mesh({"sp": 8})
    cases = {}
    try:
        for causal in (False, True):
            tag = "causal" if causal else "full"
            for name, fn, shape in (("ring", jring, "mha"),
                                    ("ring_gqa", jring, "gqa"),
                                    ("ring_h8", jring, "heads8"),
                                    ("ulysses", july, "heads8")):
                cases[f"{name}_{tag}"] = _jax_attention(
                    fn, ATTN[shape], causal, mesh, P(None, "sp"), seed=len(
                        cases))
        cases["ulysses_gqa_causal"] = _jax_attention(
            july, ATTN["gqa"], True, mesh, P(None, "sp"), seed=99)
    finally:
        jmesh._GLOBAL_MESH = None
    mesh = jmesh.init_mesh({"sp": 4, "mp": 2})
    try:
        tp = _jax_attention(july, (2, 32, 8, 8, 8), True, mesh,
                            P(None, "sp", "mp"), seed=7, head_axis="mp")
    finally:
        jmesh._GLOBAL_MESH = None
    return cases, tp


def _jax_llama(mesh, batches, **opts):
    """The JAX tiny Llama trained through hapi.Model(mesh=...): its
    initial and final weights, losses and the shifted in-model loss of
    the first batch after training."""
    paddle.seed(0)
    net = JLlama(JLlamaConfig.tiny(max_position_embeddings=SEQ, **opts))
    weights = _named(net)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.AdamW(3e-4, parameters=net.parameters()),
                  _LMLoss(), mesh=mesh)
    losses = [model.train_batch([b], [b.astype(np.int64)]) for b in batches]
    b = batches[0]
    net.after = dict(predict=np.asarray(model.predict_batch([b]).numpy()),
                     eval=model.eval_batch([b], [b.astype(np.int64)]))
    if model._mesh_executor is not None:
        model._mesh_executor.close()
    return weights, np.asarray(losses, np.float64), _named(net), net


def _shifted(net, ids, fused):
    net.config.fused_lm_loss = fused
    with paddle.no_grad():
        loss, _ = net(paddle.to_tensor(ids.astype(np.int64)),
                      labels=paddle.to_tensor(ids.astype(np.int64)))
    net.config.fused_lm_loss = False
    return float(loss.numpy())


def _jax_fleet(weights, batches, sgd=False):
    """The JAX ring Llama unsharded, 3 AdamW steps of its shifted loss;
    with ``sgd`` the dense Llama and SGD at ``SGD_LR``."""
    paddle.seed(0)
    net = JLlama(JLlamaConfig.tiny(max_position_embeddings=SEQ,
                                   context_parallel="" if sgd else "ring"))
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    opt = paddle.optimizer.SGD(SGD_LR, parameters=net.parameters()) if sgd \
        else paddle.optimizer.AdamW(3e-4, parameters=net.parameters())
    losses = []
    for b in batches:
        ids = paddle.to_tensor(b.astype(np.int64))
        loss, _ = net(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return np.asarray(losses), _named(net)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    rng = np.random.RandomState(0)
    vocab = JLlamaConfig.tiny().vocab_size
    batches = [rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    cases, tp = _attention_side()
    llama = {}
    for name, opts in MODES.items():
        weights, single, sfinal, snet = _jax_llama(None, batches, **opts)
        _, sharded, final, _ = _jax_llama(dict(MODE_AXES.get(name, AXES)),
                                          batches, **opts)
        llama[name] = dict(weights=weights, single=single, sharded=sharded,
                           final=final, single_final=sfinal,
                           after=snet.after,
                           shifted={f: _shifted(snet, batches[0], f)
                                    for f in (False, True)})
    weights = llama["ring"]["weights"]
    fleet_losses, fleet_final = _jax_fleet(weights, batches)
    dense_losses, dense_final = _jax_fleet(weights, batches, sgd=True)
    paddle.seed(8)
    snet = JLlama(JLlamaConfig.tiny(context_parallel="ring",
                                    max_position_embeddings=SEQ))
    snet.eval()
    ids = np.arange(2 * SEQ, dtype=np.int32).reshape(2, SEQ) % 16
    step = jstep(snet)
    step_logits = np.asarray(step(ids))
    step(ids)
    out = dict(cases=cases, tp=tp, llama=llama, batches=batches,
               fleet=dict(losses=fleet_losses, final=fleet_final,
                          dense=dict(losses=dense_losses,
                                     final=dense_final)),
               step=dict(weights=_named(snet), ids=ids, logits=step_logits,
                         cache=step._cache_size()))
    out["inputs"] = dict(
        sp_attention=dict(
            cases={n: {k: c[k] for k in ("q", "k", "v", "w", "causal")}
                   for n, c in cases.items()},
            tp={k: tp[k] for k in ("q", "k", "v", "w")}),
        sp_llama=dict(seq=SEQ, axes=dict(AXES), batches=batches,
                      modes=MODES, mode_axes=MODE_AXES,
                      weights={n: m["weights"] for n, m in llama.items()}),
        sp_fleet=dict(seq=SEQ, batches=batches, llama=weights,
                      sgd_lr=SGD_LR),
        sp_step=dict(seq=SEQ, axes=dict(AXES), ids=ids,
                     llama=out["step"]["weights"]))
    out["tmp"] = tmp_path_factory.mktemp("sp_world")
    return out


@pytest.fixture(scope="module")
def world(jax_side):
    return run_world(8, jax_side["inputs"], CASES, jax_side["tmp"])


def _part(a, r, n, dim=1):
    size = a.shape[dim] // n
    return np.take(a, range(r * size, (r + 1) * size), axis=dim)


ATTN_CASES = [f"{n}_{t}" for t in ("full", "causal")
              for n in ("ring", "ring_gqa", "ring_h8", "ulysses")] + [
    "ulysses_gqa_causal"]


class TestRingAndUlysses:
    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_each_rank_matches_its_part_of_the_jax_output(self, world,
                                                          jax_side, case):
        want = jax_side["cases"][case]
        for r, res in enumerate(result(world, "sp_attention")):
            np.testing.assert_allclose(res[case]["out"],
                                       _part(want["out"], r, 8),
                                       err_msg=f"rank {r}", **OUT_TOL)

    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_each_rank_matches_its_part_of_the_jax_gradients(
            self, world, jax_side, case):
        want = jax_side["cases"][case]
        for r, res in enumerate(result(world, "sp_attention")):
            for g in ("dq", "dk", "dv"):
                np.testing.assert_allclose(res[case][g],
                                           _part(want[g], r, 8),
                                           err_msg=f"{g} rank {r}",
                                           **GRAD_TOL)

    @pytest.mark.parametrize("case", ["ring_causal", "ulysses_causal",
                                      "ulysses_gqa_causal"])
    def test_collectives_of_each_form(self, world, case):
        # the ring: 7 forward and backward hops at sp 8 (7 of k/v, then 8
        # of the dK/dV accumulators, the last with them alone), none
        # staged on the CPU; Ulysses: 4 all-to-alls each way; with 2 kv
        # heads at sp 8, the ring
        counts = result(world, "sp_attention")[0][case]["counts"]
        if case == "ulysses_causal":
            assert counts == {"all_to_all_single": 8}
        else:
            assert counts == {"ring_exchange": 15}
        assert result(world, "sp_attention")[0][case]["staged"] == {}

    def test_ulysses_with_tensor_parallel_heads(self, world, jax_side):
        want = jax_side["tp"]
        for r, res in enumerate(result(world, "sp_attention")):
            got = res["ulysses_tp"]
            t, heads = got["heads"]
            assert heads == 4
            for g in ("out", "dq", "dk", "dv"):
                ref = _part(_part(want[g], r // 2, 4), t, 2, dim=2)
                np.testing.assert_allclose(got[g], ref, err_msg=g,
                                           **GRAD_TOL)


class TestSequenceParallelLlama:
    @pytest.mark.parametrize("mode", list(MODES))
    def test_losses_match_the_jax_mesh_and_single_runs(self, world,
                                                       jax_side, mode):
        rs = result(world, "sp_llama")
        want = jax_side["llama"][mode]
        for res in rs:
            assert res[mode]["losses"] == rs[0][mode]["losses"]
            assert res[mode]["sharded"]
            assert res[mode]["part"] == PARTS.get(mode, (2, 4))
        got = np.asarray(rs[0][mode]["losses"])
        np.testing.assert_allclose(got, want["sharded"], **LOSS_TOL)
        np.testing.assert_allclose(got, want["single"], **LOSS_TOL)

    @pytest.mark.parametrize("mode", list(MODES))
    def test_gathered_weights_match_the_jax_mesh_run(self, world, jax_side,
                                                     mode):
        res = result(world, "sp_llama")[0][mode]
        for name, want in jax_side["llama"][mode]["final"].items():
            np.testing.assert_allclose(res["final"][name], want,
                                       err_msg=name, **WEIGHT_TOL)

    @pytest.mark.parametrize("mode", list(MODES))
    def test_predict_and_eval_are_whole(self, world, jax_side, mode):
        # after training: predict's logits gathered whole (every rank's
        # positions, every data rank's rows), evaluate's loss the global
        # mean, against the JAX model unsharded after its 3 steps
        want = jax_side["llama"][mode]["after"]
        for res in result(world, "sp_llama"):
            np.testing.assert_allclose(res[mode]["predict"], want["predict"],
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(res[mode]["eval"], want["eval"],
                                       **LOSS_TOL)

    @pytest.mark.parametrize("mode", ["ring", "sequence_parallel"])
    @pytest.mark.parametrize("fused", [False, True])
    def test_shifted_loss_is_the_global_mean(self, world, jax_side, mode,
                                             fused):
        # the model's own labels shift across the shard boundaries, the
        # sum over the whole sequence's count (after the 3 steps)
        want = jax_side["llama"][mode]["shifted"][fused]
        for res in result(world, "sp_llama"):
            np.testing.assert_allclose(res[mode]["shifted"][fused], want,
                                       rtol=1e-5)

    def test_fleet_sep_degree_matches_the_jax_single_run(self, world,
                                                         jax_side):
        rs = result(world, "sp_fleet")
        want = jax_side["fleet"]
        for r, res in enumerate(rs):
            assert res["losses"] == rs[0]["losses"]
            assert res["sep"] == (4, r % 4)
        np.testing.assert_allclose(rs[0]["losses"], want["losses"],
                                   **LOSS_TOL)
        for name, w in want["final"].items():
            np.testing.assert_allclose(rs[0]["final"][name], w,
                                       err_msg=name, **WEIGHT_TOL)


    def test_fleet_dense_model_after_a_sequence_parallel_one(self, world,
                                                             jax_side):
        # the sp model's mark stays with its parameters: the dense one's
        # gradients are averaged over dp, not summed over sep
        rs = result(world, "sp_fleet")
        want = jax_side["fleet"]["dense"]
        for res in rs:
            assert res["dense"]["losses"] == rs[0]["dense"]["losses"]
        got = rs[0]["dense"]
        np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
        for name, w in want["final"].items():
            np.testing.assert_allclose(got["final"][name], w, err_msg=name,
                                       **WEIGHT_TOL)


class TestRefusals:
    def test_what_a_sequence_parallel_mesh_refuses(self, world):
        for res in result(world, "sp_refusals"):
            assert "does not split over 4 sp ranks" in res["odd_sequence"]
            assert "mixture-of-experts" in res["moe"]
            # neither option: replicated over sp, rows cut on data only
            assert res["dense"] == (False, None, (1, 8))


class TestRingSpStep:
    def test_dense_fallback_matches_the_jax_step(self, jax_side):
        from paddle_tpu_torch.convert import from_jax_state_dict
        from paddle_tpu_torch.models import LlamaConfig
        from paddle_tpu_torch.models.generation import make_ring_sp_step

        want = jax_side["step"]
        net = from_jax_state_dict(want["weights"], LlamaConfig.tiny(
            context_parallel="ring", max_position_embeddings=SEQ),
            device="cpu")
        step = make_ring_sp_step(net)
        got = step(torch.from_numpy(want["ids"]))
        np.testing.assert_allclose(got.numpy(), want["logits"], rtol=1e-4,
                                   atol=1e-4)
        step(want["ids"])
        assert step._cache_size() == want["cache"] == 1
        assert make_ring_sp_step(net) is step

    def test_each_rank_gives_its_rows_of_the_jax_logits(self, world,
                                                        jax_side):
        want = jax_side["step"]["logits"]
        for res in result(world, "sp_step"):
            r = res["coord"]["sp"]
            np.testing.assert_allclose(res["logits"], _part(want, r, 4),
                                       rtol=1e-4, atol=1e-4)
            assert res["same"] and res["cache"] == 1 and res["kept"]

    def test_step_is_registered_as_ring_sp(self):
        # tracked under the reference's kind: two calls with one
        # signature, one compile (the no-retrace contract)
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.models.generation import make_ring_sp_step
        from paddle_tpu_torch.observability import compile_stats

        net = LlamaForCausalLM(LlamaConfig.tiny(context_parallel="ring"),
                               device="cpu")
        step = make_ring_sp_step(net)
        assert step.label == "ring_sp"
        before = compile_stats().get("ring_sp", {"calls": 0, "compiles": 0})
        ids = torch.zeros((1, 4), dtype=torch.int64)
        step(ids)
        step(ids)
        after = compile_stats()["ring_sp"]
        assert after["calls"] - before["calls"] == 2
        assert after["compiles"] - before["compiles"] == 1
