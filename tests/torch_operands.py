"""Seeded numpy operands of the port's attention kernels, shared by the
tests against the JAX package (test_torch_kernels.py) and the tests on
the card (test_torch_cuda.py).  numpy only: the card's tests import
neither JAX nor the JAX package."""
import numpy as np


def decode_operands(B=2, KVH=2, rep=2, D=8, bs=4, nbs=4, seed=0):
    """Pools with a poisoned block 0 (owned by no sequence) and frontiers
    that straddle block boundaries (the JAX package's own test inputs)."""
    rng = np.random.RandomState(seed)
    H = KVH * rep
    nb = 1 + B * nbs
    max_pos = nbs * bs + 1
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k_new = rng.randn(B, 1, KVH, D).astype(np.float32)
    v_new = rng.randn(B, 1, KVH, D).astype(np.float32)
    k_pool = rng.randn(nb, bs, KVH, D).astype(np.float32)
    v_pool = rng.randn(nb, bs, KVH, D).astype(np.float32)
    k_pool[0] = 1e3
    v_pool[0] = -1e3
    block_table = (1 + np.arange(B * nbs)).reshape(B, nbs).astype(np.int32)
    positions = np.array([bs + 1, (nbs - 1) * bs + 2][:B], dtype=np.int32)
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    ang = np.arange(max_pos)[:, None] * inv[None, :]
    return [q, k_new, v_new, k_pool, v_pool, block_table, positions,
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)]


def chunk_operands(B=2, T=6, KVH=2, rep=2, D=8, bs=4, nbs=6, seed=0):
    rng = np.random.RandomState(seed)
    H = KVH * rep
    nb = 1 + B * nbs
    q = rng.randn(B, T, H, D).astype(np.float32)
    k_pool = rng.randn(nb, bs, KVH, D).astype(np.float32)
    v_pool = rng.randn(nb, bs, KVH, D).astype(np.float32)
    k_pool[0] = 1e3            # garbage block 0: padded writes land here
    v_pool[0] = -1e3
    block_table = (1 + np.arange(B * nbs)).reshape(B, nbs).astype(np.int32)
    positions = np.array([0, 9][:B], np.int32)
    return [q, k_pool, v_pool, block_table, positions]


def running_slots(eidx, E):
    """The MoE layer's capacity slots of expert ids ``eidx`` [T, K]: the
    running count of earlier choices of each expert, tokens major."""
    flat = eidx.reshape(-1)
    onehot = np.eye(E, dtype=np.int32)[flat]
    pos = np.cumsum(onehot, 0) - onehot
    return pos[np.arange(flat.size), flat].reshape(eidx.shape) \
        .astype(np.int32)


def moe_routing(case, T, E, C, K=2, seed=0):
    """(eidx, sidx, weights) [T, K] int32, int32, f32 of one routing case
    of the MoE dispatch/combine kernels:
    - "random": random slots up to C + 1, so choices are dropped, slots
      are named by several choices and some by none; random weights;
    - "unique": the model's forward on a skewed routing (expert 0 takes
      most first choices): running-count slots, some past C; weight 1;
    - "clamped": the form a backward pass gives dispatch: slots clamped
      to C - 1, the dropped choices at weight 0."""
    rng = np.random.RandomState(seed)
    eidx = np.stack([rng.choice(E, K, replace=False) for _ in range(T)]) \
        .astype(np.int32)
    w = rng.rand(T, K).astype(np.float32) + 0.25
    if case == "random":
        sidx = rng.randint(0, C + 2, (T, K)).astype(np.int32)
    elif case == "unique":
        first = np.where(rng.rand(T) < 0.6, 0, rng.randint(0, E, T))
        second = (first + 1 + rng.randint(0, E - 1, T)) % E
        eidx = np.stack([first, second], 1).astype(np.int32)
        sidx = running_slots(eidx, E)
        assert (sidx >= C).any() and (sidx < C).any()
        w = np.ones((T, K), np.float32)
    else:
        sidx = running_slots(eidx, E) * 3
        w = w * (sidx < C)
        sidx = np.minimum(sidx, C - 1)
    return eidx, sidx, w
