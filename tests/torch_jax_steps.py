"""Steps of the JAX package run as references by the port's tests on the
CPU (test_torch_kernels.py, test_torch_quant_serving.py)."""
import jax.numpy as jnp
import numpy as np

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig
from paddle_tpu.models.llama import LlamaAttention, PagedKVCache


def jax_chunk_write(k_pool, v_pool, k, v, block_table, positions,
                    write_mask, k_scale=None, v_scale=None, kv_dtype=None):
    """The pools after one JAX prefill chunk step: the reference's
    ``LlamaAttention`` forward over a ``PagedKVCache`` with the chunk's
    write mask, which writes the chunk's k and v (``_scatter``, or
    ``_scatter_q`` into code pools) before it attends.

    Its k and v projections select k and v out of the hidden state
    (identity columns, exact in f32) and its RoPE tables are cos 1,
    sin 0, so the write receives k and v as given: the rotated k a
    chunk's write takes.  k, v: numpy f32 [B, T, KVH, D] (values of the
    pools' type); pools [nb, bs, KVH, D] numpy of the pools' type.
    Returns numpy (k_pool, v_pool) or, for code pools, (k_pool, v_pool,
    k_scale, v_scale)."""
    B, T, KVH, D = k.shape
    E = KVH * D
    cfg = LlamaConfig(hidden_size=2 * E, num_attention_heads=2 * E // D,
                      num_key_value_heads=KVH, intermediate_size=16,
                      num_hidden_layers=1, vocab_size=32)
    att = LlamaAttention(cfg)
    sel = np.eye(2 * E, dtype=np.float32)
    att.q_proj.weight.set_value(sel)
    att.k_proj.weight.set_value(sel[:, :E])
    att.v_proj.weight.set_value(sel[:, E:])
    hidden = np.concatenate([k.reshape(B, T, E), v.reshape(B, T, E)], -1)
    n_pos = int(np.max(positions)) + T
    cos, sin = jnp.ones((n_pos, D // 2)), jnp.zeros((n_pos, D // 2))
    scales = () if kv_dtype is None else (jnp.asarray(k_scale),
                                          jnp.asarray(v_scale))
    cache = PagedKVCache(jnp.asarray(k_pool), jnp.asarray(v_pool),
                         jnp.asarray(block_table), *scales,
                         kv_dtype=kv_dtype)
    _, new = att(paddle.to_tensor(hidden.astype(np.float32)), cos, sin,
                 attn_mask=jnp.asarray(write_mask), cache=cache,
                 position_offset=jnp.asarray(positions))
    out = (new.k, new.v) if kv_dtype is None else \
        (new.k, new.v, new.k_scale, new.v_scale)
    return tuple(np.asarray(x) for x in out)
