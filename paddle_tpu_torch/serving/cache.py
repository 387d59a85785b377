"""Block-based KV-cache pool with content-addressed prefix caching.

The port of ``paddle_tpu/serving/cache.py`` for full-precision pools.
The pool owns per-layer (k, v) tensors of shape ``[num_blocks,
block_size, kv_heads, head_dim]`` on the model's device; sequences own
BLOCKS handed out from a free list as their frontier grows.  On top of
the free list:

- **refcounts** — ``_owners[block]`` is the set of request ids holding
  it; a block is recycled only when its last owner lets go;
- **chained content hashes** — a full block of prompt tokens is indexed
  by ``hash(parent_hash || block token ids)``, so matching block i
  implies blocks 0..i-1 matched too; only full blocks are registered;
- **LRU eviction** — a block whose last owner releases it while its
  content is still indexed parks in an LRU list, matchable for free,
  and is evicted only when ``allocate`` runs dry.

Registered blocks are immutable: a request that must write inside one
first breaks the share with :meth:`ensure_writable`, a copy-on-write
copy of the block (every layer, k and v) into a private block.

Block 0 is a reserved garbage sink: idle slots and padded chunk
positions write there, and attention masks it.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch


class PoolExhausted(Exception):
    """No free or evictable blocks: the caller must preempt or wait."""


class BlockKVPool:
    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype=torch.float32,
                 device="cpu", enable_prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the reserved "
                             "garbage sink)")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.enable_prefix_cache = enable_prefix_cache
        # the same namespace string as the reference's full-precision
        # pools ("fp32:<model dtype>") seeds every hash chain
        self._hash_seed = self.kv_dtype_tag.encode()
        shape = (num_blocks, block_size, kv_heads, head_dim)
        # one tensor per layer and side: the steps write them in place
        self.layers: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
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
        return "fp32:" + str(self.dtype).removeprefix("torch.")

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

    def block_bytes(self) -> int:
        """Device bytes one block costs across all layers, k and v."""
        esize = torch.empty((), dtype=self.dtype).element_size()
        return (self.num_layers * 2 * self.block_size * self.kv_heads
                * self.head_dim * esize)

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
        for k, v in self.layers:
            k[dst].copy_(k[src])
            v[dst].copy_(v[src])

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
        }
