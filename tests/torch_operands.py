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
