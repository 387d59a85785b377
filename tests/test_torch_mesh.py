"""The mesh runtime of paddle_tpu_torch against the JAX package, on the
CPU: the collectives, the four mp ops and the parallel layers, the ZeRO
stages, the global-norm clip over parts, the topology, the sampler, the
sharding helpers and the refusals.

The port's side runs as one world of 8 ranks (gloo, one process a rank,
started by the port's launcher: ``torch_mesh_world``) shared by the
module's cases; the JAX side runs here on the conftest's 8 virtual CPU
devices, and hands its weights and data over as numpy arrays.
Tolerances: f32 losses and weights 1e-5 relative (the reductions over
ranks sum in another order than XLA's), the norm 1e-6; exact where the
arithmetic is the same (collectives of integers in f32, index lists,
ZeRO stage 1 against the port's unsharded run).
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
import paddle_tpu.io as jio
import paddle_tpu.nn as jnn
from paddle_tpu import jit
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import DistributedStrategy
from paddle_tpu.optimizer import AdamW as JAdamW

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed.launch import Controller
from paddle_tpu_torch.resilience import ResilientCheckpointer
from torch_mesh_world import result, run_world

N = 8
CASES = ("collectives", "mp_ops", "tp_dp_net", "zero", "group_sharded",
         "clip", "topology", "data_parallel", "data_parallel_resilience",
         "sharding_helpers", "refusals")


def _jreset():
    jmesh._GLOBAL_MESH = None
    jmesh._GLOBAL_HCG = None


def _jfleet(**hc):
    s = DistributedStrategy()
    s.hybrid_configs = hc
    jfleet.init(is_collective=True, strategy=s)


# ------------------------------------------------------- the JAX side
def _jax_tp_dp():
    """test_tp_dp_training's net and 10 steps, its weights and losses."""
    from paddle_tpu.distributed.parallel_layers import (ColumnParallelLinear,
                                                        RowParallelLinear)

    _jfleet(dp_degree=2, mp_degree=4)
    try:
        class Net(jnn.Layer):
            def __init__(self):
                super().__init__()
                self.up = ColumnParallelLinear(16, 64, gather_output=False)
                self.down = RowParallelLinear(64, 16, input_is_parallel=True)
                self.head = jnn.Linear(16, 4)

            def forward(self, x):
                return self.head(self.down(jnn.functional.gelu(self.up(x))))

        paddle.seed(11)
        net = Net()
        weights = {n: np.asarray(p.numpy()) for n, p in
                   net.named_parameters()}
        net = jfleet.distributed_model(net)
        opt = jfleet.distributed_optimizer(
            JAdamW(1e-2, parameters=net.parameters()))

        @jit.to_static
        def step(x, y):
            loss = jnn.functional.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        rng = np.random.RandomState(5)
        x = rng.rand(8, 16).astype(np.float32)
        y = rng.randint(0, 4, (8,)).astype(np.int32)
        from paddle_tpu.distributed.sharding import shard_tensor

        xs = shard_tensor(paddle.to_tensor(x), placements=["dp"])
        ys = shard_tensor(paddle.to_tensor(y), placements=["dp"])
        losses = [float(step(xs, ys).numpy()) for _ in range(10)]
        final = {n: np.asarray(p.numpy()) for n, p in net.named_parameters()}
    finally:
        _jreset()
    return dict(weights=weights, x=x, y=y), losses, final


def _jax_seq():
    paddle.seed(3)
    return jnn.Sequential(jnn.Linear(16, 32), jnn.GELU(), jnn.Linear(32, 4))


def _jax_zero():
    """TestZeROStages's unsharded baseline: weights, data, losses."""
    rng = np.random.RandomState(7)
    data = [(rng.rand(8, 16).astype(np.float32),
             rng.randint(0, 4, (8,)).astype(np.int32)) for _ in range(5)]
    net = _jax_seq()
    weights = {n: np.asarray(p.numpy()) for n, p in net.named_parameters()}
    opt = JAdamW(1e-2, parameters=net.parameters())

    @jit.to_static
    def step(x, y):
        loss = jnn.functional.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
              for x, y in data]
    return dict(weights=weights, data=data), losses


def _jax_clip():
    rng = np.random.RandomState(9)
    g = dict(g_w=rng.randn(16, 64).astype(np.float32),
             g_b=rng.randn(64).astype(np.float32),
             g_r=rng.randn(16, 4).astype(np.float32), clip=1.5)
    from paddle_tpu.core.tensor import Parameter, Tensor

    keys = ("g_w", "g_b", "g_r")
    params = [Parameter(jax.numpy.zeros(g[k].shape)) for k in keys]
    grads = [Tensor(jax.numpy.asarray(g[k])) for k in keys]
    clip = jnn.ClipGradByGlobalNorm(1.5)
    clipped = [np.asarray(c.numpy()) for _, c in
               clip(list(zip(params, grads)))]
    norm = float(np.sqrt(sum((g[k].astype(np.float64) ** 2).sum()
                             for k in keys)))
    assert not np.allclose(clipped[0], g["g_w"])     # the clip scaled
    return g, norm, clipped


def _jax_collectives():
    """The reference's collectives inside shard_map over {"dp": 8}, each
    device's x_r = arange(6) + 10 r: each rank's result."""
    from paddle_tpu.distributed import collective as jc
    from paddle_tpu.distributed.pipeline import _shard_map

    mesh = jmesh.init_mesh({"dp": 8})
    try:
        g = jc.new_group(list(range(8)))
        x = np.concatenate([np.arange(6, dtype=np.float32) + 10 * r
                            for r in range(8)])

        def per_rank(body, arr, width):
            fn = _shard_map(lambda v: body(paddle.Tensor(v))._value, mesh,
                            (P("dp"),), P("dp"))
            return np.asarray(fn(jax.numpy.asarray(arr))).reshape(8, width)

        out = {}
        for op in ("sum", "max", "min", "avg"):
            out[f"all_reduce_{op}"] = per_rank(
                lambda t, op=op: jc.all_reduce(t, op, group=g), x, 6)
        prod_in = np.concatenate([np.full(2, 1.0 + r / 10, np.float32)
                                  for r in range(8)])
        out["all_reduce_prod"] = per_rank(
            lambda t: jc.all_reduce(t, "prod", group=g), prod_in, 2)
        gathered = _shard_map(
            lambda v: jax.numpy.stack([p._value for p in jc.all_gather(
                [], paddle.Tensor(v), group=g)]), mesh, (P("dp"),), P("dp"))
        out["all_gather"] = np.asarray(gathered(jax.numpy.asarray(x))
                                       ).reshape(8, 8, 6)
        rs = np.concatenate([np.arange(16, dtype=np.float32) + r
                             for r in range(8)])
        out["reduce_scatter"] = per_rank(
            lambda t: jc.reduce_scatter(t, group=g), rs, 2)
        a2a = np.concatenate([np.arange(16, dtype=np.float32) + 100 * r
                              for r in range(8)])
        out["alltoall_single"] = per_rank(
            lambda t: jc.alltoall_single(t, group=g), a2a, 16)
        out["broadcast"] = per_rank(
            lambda t: jc.broadcast(t, src=3, group=g), x, 6)
    finally:
        _jreset()
    return out


@pytest.fixture(scope="module")
def jax_side():
    tp_in, tp_losses, tp_final = _jax_tp_dp()
    zero_in, zero_losses = _jax_zero()
    clip_in, clip_norm, clip_out = _jax_clip()
    rng = np.random.RandomState(4)
    mp_in = dict(x=rng.randn(4, 8).astype(np.float32),
                 w=rng.randn(4, 8).astype(np.float32))
    return dict(
        inputs=dict(tp_dp_net=tp_in, zero=zero_in, group_sharded=zero_in,
                    clip=clip_in, mp_ops=mp_in),
        tp_losses=tp_losses, tp_final=tp_final, zero_losses=zero_losses,
        clip_norm=clip_norm, clip_out=clip_out, mp=mp_in,
        collectives=_jax_collectives())


@pytest.fixture(scope="module")
def world(jax_side, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_world")
    jax_side["inputs"]["data_parallel_resilience"] = {"tmp": str(tmp)}
    return run_world(N, jax_side["inputs"], CASES, tmp)


# -------------------------------------------------------- collectives
class TestCollectives:
    @pytest.mark.parametrize("key", [
        "all_reduce_sum", "all_reduce_max", "all_reduce_min",
        "all_reduce_avg", "all_gather", "reduce_scatter", "alltoall_single",
        "broadcast"])
    def test_against_the_reference_in_shard_map(self, world, jax_side, key):
        got = np.stack([r[key] for r in result(world, "collectives")])
        np.testing.assert_allclose(got, jax_side["collectives"][key],
                                   rtol=1e-6)

    def test_prod_against_the_reference(self, world, jax_side):
        # the reference's prod is exp(sum(log v)): within f32 rounding
        got = np.stack([r["all_reduce_prod"]
                        for r in result(world, "collectives")])
        np.testing.assert_allclose(got, jax_side["collectives"]
                                   ["all_reduce_prod"], rtol=1e-5)

    def test_list_forms_point_to_point_and_objects(self, world):
        rs = result(world, "collectives")
        x = [np.arange(6, dtype=np.float32) + 10 * r for r in range(N)]
        for r, res in enumerate(rs):
            np.testing.assert_array_equal(res["alltoall"], np.stack(
                [np.full(3, 10 * j + r, np.float32) for j in range(N)]))
            np.testing.assert_array_equal(
                res["reduce_scatter_list"],
                sum(np.arange(16, dtype=np.float32).reshape(8, 2)[r] + k
                    for k in range(N)))
            np.testing.assert_array_equal(res["scatter"], np.full(6, r))
            np.testing.assert_array_equal(res["ring_recv"], x[(r - 1) % N])
            assert res["all_gather_object"] == list(range(N))
            assert res["broadcast_object_list"] == 5
            assert res["barrier"] is True
            assert res["odd_group_rank"] == (r // 2 if r % 2 else -1)
            if r % 2:
                np.testing.assert_array_equal(
                    res["odd_group_sum"], sum(x[k] for k in (1, 3, 5, 7)))
        np.testing.assert_array_equal(rs[1]["reduce_dst1"], sum(x))

    def test_sums_round_once_and_means_of_equal_values_are_exact(self, world):
        for res in result(world, "collectives"):
            want = torch.tensor(sum(1.0 + 2.0 ** -7 * r for r in range(N))
                                ).bfloat16().float().item()
            np.testing.assert_array_equal(res["sum_rounded_once_bf16"],
                                          np.full(4, want, np.float32))
            np.testing.assert_array_equal(res["mean_equal"],
                                          np.full(5, 0.1, np.float32))

    def test_gloo_on_the_cpu_stages_nothing(self, world):
        for res in result(world, "collectives"):
            assert res["staged"] == {}
            assert res["counts"]["all_reduce"] >= 5

    def test_eager_identity_world1(self):
        t = torch.rand(3)
        before = t.clone()
        tdist.all_reduce(t)
        assert torch.equal(t, before)
        tdist.broadcast(t, 0)
        tdist.barrier()
        assert tdist.all_gather([], t)[0] is t
        with pytest.raises(RuntimeError, match="peer"):
            tdist.send(t, 0)


# ------------------------------------------- mp ops and parallel layers
class TestParallelLayers:
    def test_mp_ops_forward_and_backward(self, world, jax_side):
        x, w = jax_side["mp"]["x"], jax_side["mp"]["w"]
        for r, res in enumerate(result(world, "mp_ops")):
            k = r % 4                        # the rank's mp coordinate
            s = slice(2 * k, 2 * k + 2)
            y, gx = res["allreduce"]
            np.testing.assert_allclose(y, 10 * x, rtol=1e-6)
            np.testing.assert_allclose(gx, (k + 1) * w, rtol=1e-6)
            y, gx = res["identity"]          # the 4 ranks' w summed
            np.testing.assert_allclose(y, (k + 1) * x, rtol=1e-6)
            np.testing.assert_allclose(gx, 4 * (k + 1) * w, rtol=1e-6)
            y, gx = res["all_gather"]
            np.testing.assert_allclose(y, x * np.repeat(
                np.arange(1, 5, dtype=np.float32), 2), rtol=1e-6)
            np.testing.assert_allclose(gx, (k + 1) * w[:, s], rtol=1e-6)
            y, gx = res["scatter"]
            np.testing.assert_allclose(y, (k + 1) * x[:, s], rtol=1e-6)
            np.testing.assert_allclose(gx, (k + 1) * w, rtol=1e-6)

    def test_tp_dp_net_trains_to_the_reference(self, world, jax_side):
        rs = result(world, "tp_dp_net")
        for res in rs:
            np.testing.assert_allclose(res["losses"], jax_side["tp_losses"],
                                       rtol=1e-5, atol=1e-6)
            assert "mp" in res["up_spec"]
        assert jax_side["tp_losses"][-1] < jax_side["tp_losses"][0]
        for name, want in jax_side["tp_final"].items():
            np.testing.assert_allclose(rs[0]["final"][name], want,
                                       rtol=1e-5, atol=1e-6, err_msg=name)

    def test_vocab_parallel_embedding(self, world):
        for res in result(world, "topology"):
            np.testing.assert_array_equal(
                res["vocab_lookup"][0], res["vocab_full"][[0, 5, 11, 15]])


# ---------------------------------------------------------------- ZeRO
class TestZeROStages:
    @pytest.mark.parametrize("stage", [1, 2, 3])
    def test_stages_match_unsharded(self, world, jax_side, stage):
        rs = result(world, "zero")
        for res in rs:
            np.testing.assert_allclose(res[stage]["losses"],
                                       jax_side["zero_losses"], rtol=2e-5,
                                       atol=2e-6)
            assert res[stage]["mesh"] == {"dp": 4, "sharding": 2}
            # the slots hold a part; the parameter a part at stage 3 only
            assert res[stage]["slot_shape"] == (16, 16)
            assert res[stage]["param_shape"] == (
                (16, 16) if stage == 3 else (32, 16))
        state = rs[0][stage]["state"]        # gathered whole on rank 0
        assert {k: v.shape for k, v in state.items()} == {
            "moment1_0": (32, 16), "moment1_1": (32,),
            "moment1_2": (4, 32), "moment1_3": (4,)}

    def test_stage1_with_equal_gradients_is_bit_identical(self, world):
        for res in result(world, "zero"):
            assert res[1]["losses"] == res["base"]
            for name, w in res["base_final"].items():
                np.testing.assert_array_equal(res[1]["final"][name], w)

    @pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
    def test_group_sharded_parallel(self, world, jax_side, level):
        for res in result(world, "group_sharded"):
            np.testing.assert_allclose(res[level], jax_side["zero_losses"],
                                       rtol=2e-5, atol=2e-6)

    def test_group_sharded_refusals(self, world):
        res = result(world, "group_sharded")[0]
        assert res[str(dict(level="bad"))] == "ValueError"
        assert res[str(dict(level="os", offload=True))] == \
            "NotImplementedError"


# ---------------------------------------------------------------- clip
class TestClipOverParts:
    def test_global_norm_and_clipped_grads(self, world, jax_side):
        for res in result(world, "clip"):
            np.testing.assert_allclose(res["norm"], jax_side["clip_norm"],
                                       rtol=1e-6)
            for got, want in zip(res["clipped"], jax_side["clip_out"]):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("norm_type", [2.0, float("inf")])
    def test_clip_grad_norm_counts_each_part_once(self, world, jax_side,
                                                  norm_type):
        g = jax_side["inputs"]["clip"]
        full = [g["g_w"], g["g_b"], g["g_r"]]
        if norm_type == 2.0:
            want = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                               for a in full))
        else:
            want = max(np.abs(a).max() for a in full)
        scale = min(1.5 / max(want, 1e-6), 1.0)
        for res in result(world, "clip"):
            np.testing.assert_allclose(res[f"total_{norm_type}"], want,
                                       rtol=1e-6)
            for got, a in zip(res[f"grads_{norm_type}"], full):
                np.testing.assert_allclose(got, a * scale, rtol=1e-6,
                                           atol=1e-7)


# ------------------------------------------------------------ topology
class TestTopology:
    def test_hybrid_group_on_every_rank(self, world):
        for r, res in enumerate(result(world, "topology")):
            d, m = divmod(r, 4)
            assert (res["dp"], res["mp"], res["pp"], res["sharding"]) == \
                (2, 4, 1, 1)
            assert (res["dp_rank"], res["mp_rank"], res["stage"]) == (d, m, 0)
            assert res["dp_group"] == [m, m + 4]
            assert res["mp_group"] == [4 * d + k for k in range(4)]
            assert (res["dp_src"], res["mp_src"]) == (m, 4 * d)
            assert res["first"] and res["last"] and res["nranks"] == 8
            assert res["mode"] == "model"
            assert res["axes"] == {"dp": 2, "mp": 4}
            assert res["coord"] == {"dp": d, "mp": m}
            assert res["both"] == list(range(8))
            assert res["util_sum"] == [28]
            per, rem = divmod(10, 8)
            begin = r * per + min(r, rem)
            assert res["file_shard"] == list(range(begin, begin + per + (
                1 if r < rem else 0)))
            assert res["env"] == (r, 8, r)

    @pytest.mark.parametrize("names,dims", [
        (("data", "pipe", "sharding", "model"), (2, 1, 2, 2)),
        (("data", "model"), (4, 2)), (("x",), (3,))])
    def test_communicate_topology(self, names, dims):
        from paddle_tpu.distributed.mesh import CommunicateTopology as JTopo

        t, j = tdist.CommunicateTopology(names, dims), JTopo(names, dims)
        assert t.world_size() == j.world_size()
        for axis in names:
            assert t.get_comm_list(axis) == j.get_comm_list(axis)
            assert t.get_dim(axis) == j.get_dim(axis)
            for i in range(t.get_dim(axis)):
                assert t.get_axis_list(axis, i) == j.get_axis_list(axis, i)
        for rank in range(t.world_size()):
            assert t.get_coord(rank) == j.get_coord(rank)
            assert t.get_rank(**dict(zip(names, t.get_coord(rank)))) == rank


# ------------------------------------------------------------- sampler
class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("n,bs,replicas,shuffle,drop_last", [
    (10, 3, 4, False, False), (10, 3, 4, True, False),
    (10, 3, 4, True, True), (17, 2, 3, True, False), (8, 4, 2, False, True),
    (5, 2, 8, True, False)])
def test_distributed_batch_sampler_matches_the_reference(n, bs, replicas,
                                                         shuffle, drop_last):
    for rank in range(replicas):
        t = pt.io.DistributedBatchSampler(_Range(n), bs, replicas, rank,
                                          shuffle, drop_last)
        j = jio.DistributedBatchSampler(_Range(n), bs, replicas, rank,
                                        shuffle, drop_last)
        for epoch in (0, 3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
            assert len(t) == len(j)


# -------------------------------------------------- sharding helpers
class TestShardingHelpers:
    def test_parts_of_a_data_fsdp_tp_mesh(self, world):
        t = np.arange(64, dtype=np.float32).reshape(8, 8)
        for r, res in enumerate(result(world, "sharding_helpers")):
            d, f, tp = r // 4, (r // 2) % 2, r % 2
            np.testing.assert_array_equal(
                res["shard"], t[4 * f:4 * f + 4, 4 * tp:4 * tp + 4])
            assert res["spec"] == ("fsdp", "tp")
            np.testing.assert_array_equal(res["gathered"], t)
            np.testing.assert_array_equal(res["marked"], t[4 * f:4 * f + 4])
            i = 2 * d + tp                   # ("data", "tp"), mesh order
            np.testing.assert_array_equal(res["reshard"], t[2 * i:2 * i + 2])
            assert res["noop"]
            assert res["shard_shape"] == (4, 4)
            assert res["clean"] == ((), (), ("fsdp", "tp"))
            np.testing.assert_array_equal(res["batch"], t[4 * d:4 * d + 4])

    def test_data_parallel_wrapper(self, world):
        rs = result(world, "data_parallel")
        for res in rs:
            np.testing.assert_array_equal(res["w0"], rs[0]["w0"])
            np.testing.assert_allclose(
                res["synced"], np.mean([x["local"] for x in rs], axis=0),
                rtol=1e-6)
            assert res["scaled"] == 2.0

    def test_data_parallel_checkpoints_once_and_resumes_every_rank(
            self, world):
        """Rank 0 alone writes the checkpoints of a replica a rank, and
        every rank resumes from them: a fresh model of other weights
        ends bit for bit where the first one did, on every rank."""
        rs = result(world, "data_parallel_resilience")
        for res in rs:
            assert res["steps"] == ["step_00000002", "step_00000004"]
            assert res["resumed_from"] == 4
            assert res["same"]
            assert all(np.isfinite(res["cont"]))
            for name, w in res["first"][0].items():
                np.testing.assert_array_equal(w, rs[0]["first"][0][name])


# ------------------------------------------------------------ refusals
class TestRefusals:
    @pytest.mark.parametrize("key,kind,word", [
        ("pipeline", "NotImplementedError", "A5"),
        ("install_serving", "NotImplementedError", "A3"),
        ("reconcile_train", "NotImplementedError", "A5"),
        ("reconcile_serving", "NotImplementedError", "A5"),
        ("wrong_size", "ValueError", "needs"),
        ("mesh_size", "ValueError", "needs")])
    def test_refused_across_ranks(self, world, key, kind, word):
        for res in result(world, "refusals"):
            assert res[key] is not None and res[key][0] == kind, res[key]
            assert word in res[key][1]

    @pytest.mark.parametrize("key,part,want", [
        ("moe", "moe_part", (4, 32, 64)),        # [E, h / fsdp, m / tp]
        ("tied", "tied_part", (128, 32)),         # [V / tp, h / fsdp]
        ("fused_loss_tp", None, None),
        ("meta_optimizer", "meta_optimizer_class", "DGCMomentum")])
    def test_former_refusals_run_across_ranks(self, world, key, part, want):
        """A MoE model and tied embeddings on a tp > 1 mesh, the fused
        loss over a split vocabulary and fleet's meta-optimizers ran
        (``tests/test_torch_tensor_parallel.py`` and
        ``tests/test_torch_meta_optimizers.py`` hold them against the
        JAX package)."""
        for res in result(world, "refusals"):
            assert res[key] is None, res[key]
            if part is not None:
                assert res[part] == want

    def test_nccl_with_more_ranks_than_cards(self, monkeypatch):
        monkeypatch.setenv("LOCAL_WORLD_SIZE",
                           str(torch.cuda.device_count() + 1))
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            tdist.init_parallel_env()

    def test_gloo_needs_an_explicit_device(self):
        with pytest.raises(ValueError, match="explicit device"):
            tdist.init_parallel_env(backend="gloo")

    def test_format2_checkpoints_write_and_restore(self, tmp_path):
        """``sharded=True`` in one process: format 2, restored bit for
        bit (the world's format-2 saves: test_torch_expert_parallel.py
        and the DataParallel case above)."""
        ck = ResilientCheckpointer(str(tmp_path), sharded=True)
        w = np.arange(6, dtype=np.float32).reshape(3, 2)
        ck.save(1, {"model": {"w": w}})
        step, got = ck.restore_latest()
        assert step == 1 and ck.shard_files_written == 1
        np.testing.assert_array_equal(np.asarray(got["model"]["w"]), w)

    def test_world1_degrades(self):
        with pytest.warns(UserWarning, match="degrading"):
            ex = tdist.MeshExecutor({"data": 16, "fsdp": 1, "tp": 1})
        assert ex.degraded and ex.mesh.size == 1
        assert ex.axes == {"data": 1, "fsdp": 1, "tp": 1}
        assert tdist.current_executor() is ex
        assert tdist.default_shardplan_mesh() == ex.axes
        assert tdist.as_executor(ex) is ex
        ex.close()
        assert tdist.current_executor() is None


# -------------------------------------------------------------- launcher
def _script(tmp_path, body):
    path = tmp_path / "rank.py"
    path.write_text("import os, sys, time\nr = int(os.environ['RANK'])\n"
                    + body)
    return str(path)


class TestLauncher:
    def test_a_failing_rank_stops_the_world(self, tmp_path):
        script = _script(tmp_path, "sys.exit(3) if r == 1 else "
                                   "time.sleep(60)\n")
        ctl = Controller(script, [], nproc_per_node=3, timeout=50)
        assert ctl.run() == 3
        assert all(p.poll() is not None for p in ctl.procs)

    def test_timeout_kills_every_rank(self, tmp_path):
        script = _script(tmp_path, "time.sleep(60)\n")
        ctl = Controller(script, [], nproc_per_node=2, timeout=1)
        assert ctl.run() == 124
        assert all(p.poll() is not None for p in ctl.procs)

    def test_environment_logs_and_restarts(self, tmp_path):
        marker = tmp_path / "tried"
        script = _script(tmp_path, (
            f"m = {str(marker)!r} + str(r)\n"
            "print(os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'],"
            " os.environ['MASTER_PORT'] != '')\n"
            "if r == 1 and not os.path.exists(m):\n"
            "    open(m, 'w').close()\n    sys.exit(5)\n"))
        logs = tmp_path / "logs"
        ctl = Controller(script, [], nproc_per_node=2, max_restarts=1,
                         log_dir=str(logs))
        assert ctl.run() == 0 and ctl.restarts == 1
        assert (logs / "workerlog.1").read_text().splitlines()[-1] == \
            "2 1 True"


def test_mesh_gauges_exported():
    from paddle_tpu_torch import observability as obs

    prev = obs.enable()
    try:
        reg = obs.get_registry()
        ex = tdist.MeshExecutor({"data": 1, "tp": 1})
        assert reg.gauge("mesh_num_devices").value() == 1.0
        for ax in ("data", "tp"):
            assert reg.gauge("mesh_axis_sizes").value(axis=ax) == 1.0
        ex.close()
    finally:
        obs.enable(prev)


def test_rng_tracker_regions_replay():
    tdist.model_parallel_random_seed(7)
    tracker = tdist.get_rng_state_tracker()
    assert set(tracker.states_) == {"model_parallel_rng", "global_seed"}
    outside = torch.rand(3)
    with tracker.rng_state("global_seed"):
        a = torch.rand(3)
    tdist.model_parallel_random_seed(7)
    tracker = tdist.get_rng_state_tracker()
    with tracker.rng_state("global_seed"):
        b = torch.rand(3)
    assert torch.equal(a, b) and torch.equal(torch.rand(3), outside)
    with pytest.raises(ValueError):
        tracker.add("again", 7)


@pytest.mark.parametrize("operation,axis", [("linear", 0), ("linear", 1),
                                            ("embedding", 0)])
def test_split_on_one_rank_is_the_whole_layer(operation, axis):
    torch.manual_seed(0)
    x = torch.randint(0, 6, (2, 3)) if operation == "embedding" \
        else torch.rand(2, 6)
    out = tdist.split(x, (6, 4), operation, axis=axis)
    assert out.shape == ((2, 3, 4) if operation == "embedding" else (2, 4))
