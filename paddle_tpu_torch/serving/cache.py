"""Block-based KV-cache pool with content-addressed prefix caching.

The port of ``paddle_tpu/serving/cache.py``.  The pool owns per-layer
(k, v) tensors of shape ``[num_blocks, block_size, kv_heads, head_dim]``
on the model's device, or for a quantized pool (``kv_cache_dtype``
``"int8"``/``"fp8"``, ``kernels/kv_quant``) (k, v, k_scale, v_scale):
int8 code pools and [num_blocks, block_size] f32 row scales, which start
at 1.0.  Sequences own BLOCKS handed out from a free list as their
frontier grows.  On top of the free list:

- **refcounts** — ``_owners[block]`` is the set of request ids holding
  it; a block is recycled only when its last owner lets go;
- **chained content hashes** — a full block of prompt tokens is indexed
  by ``hash(parent_hash || block token ids)``, so matching block i
  implies blocks 0..i-1 matched too; only full blocks are registered;
  the chain's seed is the pool's storage tag (:attr:`kv_dtype_tag`), so
  pools of different KV dtypes never match each other's blocks;
- **LRU eviction** — a block whose last owner releases it while its
  content is still indexed parks in an LRU list, matchable for free,
  and is evicted only when ``allocate`` runs dry.

Registered blocks are immutable: a request that must write inside one
first breaks the share with :meth:`ensure_writable`, a copy-on-write
copy of the block (every layer, k and v, and their scale rows) into a
private block.

Block 0 is a reserved garbage sink: idle slots and padded chunk
positions write there, and attention masks it.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..kernels.kv_quant import (kv_bytes_per_element,
                                kv_scale_bytes_per_block, kv_storage_dtype,
                                resolve_kv_cache_dtype)


class PoolExhausted(Exception):
    """No free or evictable blocks: the caller must preempt or wait."""


class BlockKVPool:
    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype=torch.float32,
                 device="cpu", enable_prefix_cache: bool = True,
                 kv_cache_dtype: Optional[str] = None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the reserved "
                             "garbage sink)")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        #: quantization scheme: None (full precision) / "int8" / "fp8"
        self.kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
        #: the model's KV dtype; ``dtype`` is what the pools store
        self.model_dtype = dtype
        self.dtype = kv_storage_dtype(self.kv_cache_dtype) or dtype
        self.enable_prefix_cache = enable_prefix_cache
        # the reference's namespace strings ("int8", "fp8" or
        # "fp32:<model dtype>") seed every hash chain
        self._hash_seed = self.kv_dtype_tag.encode()
        shape = (num_blocks, block_size, kv_heads, head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.dtype, device=device)

        def ones():
            return torch.ones(shape[:2], dtype=torch.float32, device=device)

        # one tensor per layer and side: the steps write them in place
        self.layers: List[Tuple[torch.Tensor, ...]] = [
            (zeros(), zeros(), ones(), ones())
            if self.kv_cache_dtype is not None else (zeros(), zeros())
            for _ in range(num_layers)]
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._owners: Dict[int, Set] = {}
        # invariant: b in _block_hash <=> _hash_index[_block_hash[b]] == b
        self._hash_index: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        self.evictions = 0
        self.cow_copies = 0

    # ------------------------------------------------------- accounting
    @property
    def kv_dtype_tag(self) -> str:
        """The pool's storage format: ``"int8"``, ``"fp8"`` or
        ``"fp32:<model dtype>"`` (the reference's strings)."""
        if self.kv_cache_dtype is not None:
            return self.kv_cache_dtype
        return "fp32:" + str(self.model_dtype).removeprefix("torch.")

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (excludes the reserved garbage block)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        """Blocks allocatable now: free plus cached-but-unreferenced."""
        return len(self._free) + len(self._cached_free)

    @property
    def num_used(self) -> int:
        return self.capacity_blocks - self.num_free

    @property
    def num_cached(self) -> int:
        return len(self._cached_free)

    def utilization(self) -> float:
        return self.num_used / self.capacity_blocks

    @staticmethod
    def block_bytes_for(num_layers: int, block_size: int, kv_heads: int,
                        head_dim: int, dtype=torch.float32,
                        kv_cache_dtype: Optional[str] = None) -> int:
        """Device bytes one block costs across all layers, k and v, scale
        rows included: computable before the pool exists, so the engine
        can size ``num_blocks`` from a ``kv_pool_bytes`` budget."""
        scheme = resolve_kv_cache_dtype(kv_cache_dtype)
        per_side = (block_size * kv_heads * head_dim
                    * kv_bytes_per_element(scheme, dtype)
                    + kv_scale_bytes_per_block(block_size, scheme))
        return int(num_layers * 2 * per_side)

    def block_bytes(self) -> int:
        """Device bytes one block of this pool costs."""
        return self.block_bytes_for(self.num_layers, self.block_size,
                                    self.kv_heads, self.head_dim,
                                    self.model_dtype, self.kv_cache_dtype)

    def capacity_bytes(self) -> int:
        return self.capacity_blocks * self.block_bytes()

    def used_bytes(self) -> int:
        """Bytes of the blocks that live requests reference."""
        return self.num_used * self.block_bytes()

    def byte_utilization(self) -> float:
        """Fraction of the pool's KV byte capacity that live requests
        reference: the degradation ladder's pressure signal
        (``serving/overload.py``).  Blocks are alike within one pool, so
        it equals :meth:`utilization`; in bytes, pools of two KV dtypes
        sized from one ``kv_pool_bytes`` budget compare per byte."""
        return self.used_bytes() / self.capacity_bytes()

    def blocks_for(self, num_tokens: int) -> int:
        return -(-int(num_tokens) // self.block_size)

    def owned_by(self, request_id) -> List[int]:
        return [b for b, o in self._owners.items() if request_id in o]

    def refcount(self, block: int) -> int:
        return len(self._owners.get(block, ()))

    # ------------------------------------------------------- allocation
    def allocate(self, request_id, n: int = 1) -> List[int]:
        """Hand ``n`` private blocks to ``request_id``, evicting LRU
        cached blocks if needed; raises :class:`PoolExhausted` (and
        allocates nothing) when even that cannot cover ``n``."""
        if self.num_free < n:
            raise PoolExhausted(
                f"need {n} block(s), {len(self._free)} free + "
                f"{len(self._cached_free)} evictable "
                f"(capacity {self.capacity_blocks})")
        blocks = []
        for _ in range(n):
            b = self._free.pop() if self._free else self._evict_lru()
            self._owners[b] = {request_id}
            blocks.append(b)
        return blocks

    def _evict_lru(self) -> int:
        b, _ = self._cached_free.popitem(last=False)
        h = self._block_hash.pop(b, None)
        if h is not None and self._hash_index.get(h) == b:
            del self._hash_index[h]
        self.evictions += 1
        return b

    def evict_parked(self, n: Optional[int] = None) -> int:
        """Evict up to ``n`` (default: all) parked prefix-cache blocks,
        LRU first, onto the free list; returns how many.  The
        degradation ladder's first rung: parked blocks already count as
        headroom (``num_free``), but reclaiming them up front drops their
        stale index entries before a burst evicts them one by one."""
        count = 0
        while self._cached_free and (n is None or count < n):
            self._free.append(self._evict_lru())
            count += 1
        return count

    def _release_block(self, b: int):
        self._owners.pop(b, None)
        if self.enable_prefix_cache and b in self._block_hash:
            self._cached_free[b] = None
        else:
            self._free.append(b)

    def free(self, blocks: Sequence[int], request_id):
        """Drop ``request_id``'s reference on each block; a block with no
        owner left is recycled (or parked, if indexed)."""
        for b in blocks:
            owners = self._owners.get(b)
            if owners is None or request_id not in owners:
                raise ValueError(
                    f"double free of block {b} by {request_id!r} (owned by "
                    f"{sorted(map(str, owners or ()))})")
            owners.discard(request_id)
            if not owners:
                self._release_block(b)

    def free_request(self, request_id):
        """Release every block ``request_id`` references, tail first (so
        a prompt chain's leaves park in the LRU before its head)."""
        blocks = self.owned_by(request_id)
        if blocks:
            self.free(list(reversed(blocks)), request_id)

    def check_leaks(self):
        """Raise if any block is still owned by a request (parked
        prefix-cache blocks are not leaks)."""
        if self._owners:
            raise AssertionError(
                "leaked blocks: "
                f"{sorted((b, sorted(map(str, o))) for b, o in self._owners.items())}")

    # ---------------------------------------------------- prefix cache
    @staticmethod
    def _chain_hash(parent: bytes, tokens: np.ndarray) -> bytes:
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    def hash_chain(self, tokens) -> List[bytes]:
        """Chained content hashes of every FULL block of ``tokens``."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        out: List[bytes] = []
        parent = self._hash_seed
        for i in range(len(tokens) // bs):
            parent = self._chain_hash(parent, tokens[i * bs:(i + 1) * bs])
            out.append(parent)
        return out

    def match_prefix(self, tokens) -> List[int]:
        """Longest indexed prefix of ``tokens`` as block ids (pure
        lookup, stops at the first miss)."""
        if not self.enable_prefix_cache:
            return []
        out: List[int] = []
        for h in self.hash_chain(tokens):
            b = self._hash_index.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def acquire(self, request_id, blocks: Sequence[int]):
        """Add ``request_id``'s reference to already-populated blocks (a
        prefix-cache hit); parked blocks come back from the LRU."""
        for b in blocks:
            owners = self._owners.get(b)
            if owners is not None:
                owners.add(request_id)
            elif b in self._cached_free:
                del self._cached_free[b]
                self._owners[b] = {request_id}
            else:
                raise ValueError(
                    f"cannot acquire block {b}: neither owned nor cached")

    def register_prefix(self, request_id, tokens, blocks: Sequence[int]
                        ) -> int:
        """Index ``request_id``'s full prompt blocks by content (first
        writer wins); returns how many entries were added.  Registered
        blocks are immutable until evicted."""
        if not self.enable_prefix_cache:
            return 0
        added = 0
        chain = self.hash_chain(tokens)
        for h, b in zip(chain, blocks):
            if h in self._hash_index or b in self._block_hash:
                continue
            owners = self._owners.get(b)
            if owners is None or request_id not in owners:
                continue
            self._hash_index[h] = b
            self._block_hash[b] = h
            added += 1
        return added

    def ensure_writable(self, request_id, block: int) -> int:
        """Copy-on-write guard: ``block`` itself when exclusively owned
        and unindexed, otherwise a fresh private copy (the request's
        reference moves to it)."""
        owners = self._owners.get(block)
        if owners is None or request_id not in owners:
            raise ValueError(f"{request_id!r} does not own block {block}")
        if len(owners) == 1 and block not in self._block_hash:
            return block
        new = self.allocate(request_id, 1)[0]
        self._copy_block(block, new)
        owners.discard(request_id)
        if not owners:
            self._release_block(block)
        self.cow_copies += 1
        return new

    def _copy_block(self, src: int, dst: int):
        # a quantized block's scale rows move with its codes
        for entry in self.layers:
            for t in entry:
                t[dst].copy_(t[src])

    def admission_plan(self, tokens, extra_tokens: int = 1):
        """``(matched_blocks, new_blocks_needed, feasible_now)`` for one
        prompt; matched blocks parked in the LRU are not counted twice."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        matched = self.match_prefix(tokens)
        need = max(self.blocks_for(len(tokens) + extra_tokens)
                   - len(matched), 0)
        from_lru = sum(1 for b in matched if b in self._cached_free)
        return matched, need, need <= self.num_free - from_lru

    def stats(self) -> dict:
        return {
            "capacity_blocks": self.capacity_blocks,
            "used_blocks": self.num_used,
            "free_blocks": self.num_free,
            "cached_blocks": self.num_cached,
            "block_size": self.block_size,
            "utilization": round(self.utilization(), 4),
            "prefix_evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "kv_dtype": self.kv_dtype_tag,
            "block_bytes": self.block_bytes(),
            "used_bytes": self.used_bytes(),
            "capacity_bytes": self.capacity_bytes(),
            "byte_utilization": round(self.byte_utilization(), 4),
        }
