"""Tensor parallelism's leftovers in paddle_tpu_torch against the JAX
package, on the CPU: one world of 4 ranks (gloo, one process a rank,
the port's launcher through ``torch_mesh_world`` running
``tests/torch_tp_ranks.py``), the JAX package's unsharded tiny f32
models here, the same numpy weights (carried by ``convert.py``) and
batches on both.

- The fused chunked loss over a vocabulary split across tp = 2
  (``{"data": 2, "tp": 2}``, ``MeshExecutor``), untied and tied, against
  the JAX model's fused loss and its gradients, and against the port's
  own logits-path vocab-parallel loss: the loss within 1e-5 relative,
  each gradient within 1e-4 of its array's largest entry (the f32
  reductions over the ranks round in another order than XLA's).  The
  fused loss's collectives are counted apart (``fused_loss.*``): two a
  chunk, and the same again when the backward recomputes the chunk.
- Tied embeddings on tp = 2 through both entry points: ``hapi.Model(mesh=
  ...)`` with the vocab-parallel loss on the logits, and fleet ``{"dp":
  2, "mp": 2}`` (the table split by rows over mp) and ``{"mp": 2,
  "sharding": 2}`` (ZeRO stage 3: every Megatron part split over
  sharding too) with the model's own loss, fused for two steps and then
  the logits path, SGD; losses
  within 1e-5 relative, each weight's update over the run within 1e-4
  of its largest entry.  The training runs take SGD, whose update is
  linear in the gradient: AdamW moves a weight by about its learning
  rate whatever its gradient's size, and most of a tied table's
  gradient entries are 1e-10 or less here (the head's softmax is
  saturated at random weights), so the last bits of such an entry
  would decide its move.
- A MoE Llama (4 experts, top-2, the dropless capacity factor 2.0) on
  ``{"expert": 2, "tp": 2}`` through ``hapi.Model(mesh=...)`` and
  through fleet on ``{"ep": 2, "mp": 2}`` and ``{"ep": 2, "sharding":
  2}`` (ZeRO stage 3, the stacks' parts split over sharding too), SGD,
  against the JAX model unsharded: the same tolerances.  Over tp each expert's down product is a partial sum,
  kept in f32 and summed with the expert ranks' before the combine's one
  rounding, where the JAX model rounds the whole product once: in f32
  both are within the tolerance.
"""
import threading

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from torch_mesh_world import ROOT, result, run_world

RANKS = ROOT / "tests" / "torch_tp_ranks.py"
CASES = ("tp_loss", "tp_hapi_tied", "tp_fleet_tied", "tp_moe",
         "tp_moe_fleet")
SEQ, BATCH, STEPS, LR = 16, 4, 3, 0.1
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=SEQ, dtype="float32", lm_loss_chunk=8)
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
FUSED_STEPS = (True, True, False)      # the fleet run's loss path a step
LOSS_RTOL = 1e-5
REL = 1e-4                              # of an array's largest entry


def close_rel(got, want, err_msg=""):
    """|got - want| within REL of want's largest entry."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale + 1e-12,
                               err_msg=err_msg)


def _named(net):
    return {n: np.asarray(t.numpy()) for n, t in net.state_dict().items()}


def _jmodel(weights, **kw):
    net = JLlama(JLlamaConfig(**{**CFG, **kw}, use_flash_attention=False))
    net.set_state_dict({n: paddle.to_tensor(w) for n, w in weights.items()})
    return net


class _LMLoss:
    def __call__(self, logits, labels):
        vocab = logits.shape[-1]
        return jnn.functional.cross_entropy(
            logits.reshape([-1, vocab]), labels.reshape([-1]))


def _grads(net):
    return {n: np.asarray(p.grad.numpy()) for n, p in net.named_parameters()
            if p.grad is not None}


def _own_loss_steps(net, batches, lr, fused=None):
    """The JAX eager loop of the model's own loss, SGD."""
    opt = paddle.optimizer.SGD(lr, parameters=net.parameters())
    losses = []
    for i, b in enumerate(batches):
        if fused is not None:
            net.config.fused_lm_loss = fused[i]
        t = paddle.to_tensor(b.astype(np.int64))
        loss, _ = net(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _logits_loss_steps(net, batches, lr):
    """The JAX hapi loop (cross entropy of the logits against the
    batch itself), SGD."""
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(lr, parameters=net.parameters()),
                  _LMLoss())
    return [model.train_batch([b], [b.astype(np.int64)]) for b in batches]


def _jax_inputs():
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, CFG["vocab_size"], (BATCH, SEQ))
               .astype(np.int32) for _ in range(STEPS)]
    weights = {}
    for tied in (False, True):
        paddle.seed(0)
        weights[tied] = _named(JLlama(JLlamaConfig(
            **CFG, tie_word_embeddings=tied, use_flash_attention=False)))
    paddle.seed(1)
    moe = _named(JLlama(JLlamaConfig(**CFG, **MOE,
                                     use_flash_attention=False)))
    common = dict(cfg=CFG, lr=LR, batches=batches)
    inputs = dict(
        tp_loss=dict(common, weights=weights, batch=batches[0]),
        tp_hapi_tied=dict(common, weights=weights),
        tp_fleet_tied=dict(common, weights=weights, fused=FUSED_STEPS),
        tp_moe=dict(common, moe=moe, moe_cfg=MOE),
        tp_moe_fleet=dict(common, moe=moe, moe_cfg=MOE))
    return inputs, weights, moe, batches


def _jax_results(weights, moe, batches):
    out = {"loss": {}}
    t = paddle.to_tensor(batches[0].astype(np.int64))
    for tied in (False, True):
        for fused in (True, False):
            net = _jmodel(weights[tied], tie_word_embeddings=tied,
                          fused_lm_loss=fused)
            loss, _ = net(t, labels=t)
            loss.backward()
            out["loss"][(tied, fused)] = (float(loss.numpy()), _grads(net))
    net = _jmodel(weights[True], tie_word_embeddings=True)
    out["hapi_tied"] = (_logits_loss_steps(net, batches, LR), _named(net))
    net = _jmodel(weights[True], tie_word_embeddings=True)
    out["fleet_tied"] = (_own_loss_steps(net, batches, LR, FUSED_STEPS),
                         _named(net))
    net = _jmodel(moe, **MOE)
    out["moe"] = (_logits_loss_steps(net, batches, LR), _named(net))
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The port's world, run in a thread while the JAX side computes
    here."""
    inputs, weights, moe, batches = _jax_inputs()
    tmp = tmp_path_factory.mktemp("tp_world")
    box = {}
    thread = threading.Thread(
        target=lambda: box.update(world=run_world(4, inputs, CASES, tmp,
                                                  ranks=RANKS)),
        daemon=True)
    thread.start()
    jax = _jax_results(weights, moe, batches)
    thread.join()
    return dict(world=box["world"], jax=jax, weights=weights, moe=moe)


def _updates_close(final, want, init):
    assert sorted(final) == sorted(want)
    for name, w in want.items():
        close_rel(final[name] - init[name], w - init[name], err_msg=name)


class TestFusedLossOverTp:
    @pytest.mark.parametrize("tied", [False, True])
    def test_fused_loss_and_gradients_match_jax(self, sides, tied):
        for res in result(sides["world"], "tp_loss"):
            got = res[(tied, True)]
            want, grads = sides["jax"]["loss"][(tied, True)]
            assert got["vocab_group"]
            np.testing.assert_allclose(got["loss"], want, rtol=LOSS_RTOL)
            assert sorted(got["grads"]) == sorted(grads)
            for n, g in grads.items():
                close_rel(got["grads"][n], g, err_msg=n)

    @pytest.mark.parametrize("tied", [False, True])
    def test_fused_equals_the_logits_path(self, sides, tied):
        for res in result(sides["world"], "tp_loss"):
            fused, plain = res[(tied, True)], res[(tied, False)]
            want, grads = sides["jax"]["loss"][(tied, False)]
            np.testing.assert_allclose(plain["loss"], want, rtol=LOSS_RTOL)
            np.testing.assert_allclose(fused["loss"], plain["loss"],
                                       rtol=LOSS_RTOL)
            for n, g in plain["grads"].items():
                close_rel(fused["grads"][n], g, err_msg=n)
                close_rel(g, grads[n], err_msg=n)

    def test_fused_loss_collectives_counted_apart(self, sides):
        # [2, 16] rows a data rank: 30 predicted tokens in 4 chunks of 8;
        # each chunk a max and one packed sum, again in the recompute
        for res in result(sides["world"], "tp_loss"):
            for tied in (False, True):
                counts = res[(tied, True)]["counts"]
                assert counts.get("fused_loss.all_reduce") == 16, counts
                plain = res[(tied, False)]["counts"]
                assert not any(k.startswith("fused_loss") for k in plain)

    def test_tied_table_split_by_rows(self, sides):
        for res in result(sides["world"], "tp_loss"):
            split = res[(True, True)]["split"]
            assert "model.embed_tokens.weight" in split
            assert not any("lm_head" in n for n in split)


class TestTiedOverTp:
    def test_hapi_mesh_entry_point(self, sides):
        losses, final = sides["jax"]["hapi_tied"]
        for res in result(sides["world"], "tp_hapi_tied"):
            assert res["table"] == (128, 64)
            np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
            _updates_close(res["final"], final, sides["weights"][True])

    def test_fleet_mp_entry_point(self, sides):
        losses, final = sides["jax"]["fleet_tied"]
        for res in result(sides["world"], "tp_fleet_tied"):
            got = res[("dp", "mp")]
            assert got["table"] == (128, 64)
            assert "model.embed_tokens.weight" in got["split"]
            np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
            _updates_close(got["final"], final, sides["weights"][True])

    def test_fleet_mp_with_zero3_entry_point(self, sides):
        # {"mp": 2, "sharding": 2}: every Megatron part split over mp by
        # role and over sharding (ZeRO stage 3) on its fsdp dim
        losses, final = sides["jax"]["fleet_tied"]
        megatron = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                    "o_proj.weight", "gate_proj.weight", "up_proj.weight",
                    "down_proj.weight", "embed_tokens.weight")
        for res in result(sides["world"], "tp_fleet_tied"):
            got = res[("mp", "sharding")]
            parts = got["parts"]
            assert got["table"] == (128, 32)
            assert parts["model.layers.0.self_attn.q_proj.weight"] == (32, 32)
            assert parts["model.layers.0.self_attn.o_proj.weight"] == (32, 32)
            assert parts["model.layers.1.mlp.down_proj.weight"] == (64, 32)
            split = [n for n in parts if n.endswith(megatron)]
            assert len(split) == 15
            assert set(split) <= set(got["zero3"]), got["zero3"]
            np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
            _updates_close(got["final"], final, sides["weights"][True])


class TestExpertsOverTp:
    def test_expert_tp_mesh_matches_jax(self, sides):
        losses, final = sides["jax"]["moe"]
        for res in result(sides["world"], "tp_moe"):
            # 2 of 4 experts, half of each expert's FFN columns
            assert res["parts"]["model.layers.0.mlp.w_gate"] == (2, 64, 64)
            assert res["parts"]["model.layers.0.mlp.w_down"] == (2, 64, 64)
            np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
            _updates_close(res["final"], final, sides["moe"])

    @pytest.mark.parametrize("degrees,gate", [
        (("ep", "mp"), (2, 64, 64)), (("ep", "sharding"), (2, 32, 128))])
    def test_fleet_matches_jax(self, sides, degrees, gate):
        losses, final = sides["jax"]["moe"]
        for res in result(sides["world"], "tp_moe_fleet"):
            got = res[degrees]
            assert got["parts"]["model.layers.0.mlp.w_gate"] == gate
            np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
            _updates_close(got["final"], final, sides["moe"])
