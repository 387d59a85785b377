"""Speculative decoding (the port of ``paddle_tpu/serving/speculative.py``;
Leviathan et al., "Fast Inference from Transformers via Speculative
Decoding"): a small draft model proposes K tokens a step, and the target
checks all K+1 positions in one batched forward.

Two steps, each a :class:`~paddle_tpu_torch.jit.GraphStep` (one CUDA
graph on the card, replayed every iteration):

- ``draft_propose``: K+1 paged decodes of the draft, one after another
  inside the one graph, writing the draft's KV into its own layer slice
  of the shared block pool.  Pass i runs at ``lengths + i`` and draws
  proposal ``d_{i+1}`` under ``fold(fold(key, counter + i), DRAFT_TAG)``
  (greedy lanes take the argmax).  The last pass feeds ``d_K`` back only
  to write its KV: without it a fully accepted window would commit
  ``d_K`` at ``lengths + K`` while the draft's cache has a hole there,
  and every later draft pass would read it.  Returns the proposals and
  the draft's filtered distributions, which rejection sampling needs.
- ``spec_verify``: one target forward over ``[pending, d_1 .. d_K]`` at
  positions ``lengths .. lengths + K`` (the chunked-prefill attention,
  batched over the slots), then :func:`spec_acceptance` on the device.
  Only ``committed [S, K+1]`` and ``accepted_len [S]`` go to the host.

Acceptance is the reference's rule, in torch ops:

* greedy lanes (temperature 0) accept while the proposal equals the
  target's argmax; the first mismatch commits the target's argmax
  instead, so the committed tokens are the greedy continuation;
* sampled lanes accept ``d`` when ``u * max(q(d), 1e-20) < p(d)`` (target
  p, draft q, both filtered; ``u`` under ``ACCEPT_TAG``); after a
  rejection the bonus token is drawn from ``normalize(max(p - q, 0))``,
  after a full accept from p at position K (under ``BONUS_TAG``).  Every
  key is folded from the request's base key and its token index, so a
  preempted and recomputed request draws the same tokens.

The engine keeps the KV books: the verify writes all K+1 positions in
place, and the engine cuts each slot back to its accepted length and
frees the blocks wholly past it (``Engine._rollback_blocks``).  Keys
past a frontier are masked by the attention, so the rows left in kept
blocks are never read and the next iteration overwrites them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..jit import GraphStep
from ..models.generation import (_cache_dims, _paged_caches, paged_decode,
                                 resolve_fused)
from .sampling import (ACCEPT_TAG, BONUS_TAG, DRAFT_TAG, categorical,
                       filtered_probs, fold_keys, sample_tokens, uniform)


@dataclass
class SpeculativeConfig:
    """``ServingConfig.speculative``: the draft model (a
    ``LlamaForCausalLM`` that shares the target's vocabulary, KV heads,
    head_dim and dtype, so that both live in one
    :class:`~paddle_tpu_torch.serving.cache.BlockKVPool`) and the number
    of draft tokens proposed a verify step."""

    draft_model: Any
    num_draft_tokens: int = 4

    def __post_init__(self):
        if self.num_draft_tokens < 1:
            raise ValueError("num_draft_tokens must be >= 1, got "
                             f"{self.num_draft_tokens}")

    def validate_against(self, model):
        """Both models' KV share one pool, addressed by the same block
        tables, so a position's cache geometry must match."""
        draft, target = _cache_dims(self.draft_model), _cache_dims(model)
        if draft != target:
            raise ValueError(
                f"draft/target cache layouts differ (draft {draft} vs "
                f"target {target}): speculative decoding shares one "
                "BlockKVPool, so kv_heads, head_dim and dtype must match")
        dv = self.draft_model.config.vocab_size
        tv = model.config.vocab_size
        if dv != tv:
            raise ValueError(f"draft vocab {dv} != target vocab {tv}: "
                             "speculative decoding needs a shared "
                             "tokenizer")


def make_draft_propose_step(draft, num_draft, kv_cache_dtype=None,
                            pool=None, fused=None):
    """``step(tok [S, 1], pools, block_tables [S, max_blocks], lengths
    [S], temps [S] f32, top_ks [S], top_ps [S] f32, keys [S, 2] int64,
    counters [S]) -> (proposals [S, K] int64, draft_probs [S, K, V]
    f32)``, writing the draft's KV at ``lengths .. lengths + K`` in place
    (the module docstring).  The last pass's logits are not sampled: the
    reference draws from them and discards the draw.  A
    :class:`~paddle_tpu_torch.jit.GraphStep` that binds the pools and the
    engine's five per-slot sampling tensors by address, as the sampled
    decode step does (``pool``: its graph memory pool; ``fused`` the
    serving mode of the draft's decodes)."""
    decode = paged_decode(draft, kv_cache_dtype, fused)

    @torch.inference_mode()
    def step(tok, pools, block_tables, lengths, temps, top_ks, top_ps,
             keys, counters):
        props, probs = [], []
        cur = tok
        for i in range(num_draft + 1):
            last = decode(cur, pools, block_tables, lengths + i)
            if i == num_draft:
                break
            nxt = sample_tokens(last, temps, top_ks, top_ps, fold_keys(
                fold_keys(keys, counters + i), DRAFT_TAG))
            props.append(nxt)
            probs.append(filtered_probs(last, temps, top_ks, top_ps))
            cur = nxt[:, None].to(tok.dtype)
        return torch.stack(props, 1), torch.stack(probs, 1)

    return GraphStep(step, draft.device, bound=(1, 4, 5, 6, 7, 8),
                     pool=pool)


def spec_acceptance(lg, proposals, draft_probs, temps, top_ks, top_ps,
                    keys, counters):
    """The acceptance rule over the verify logits ``lg [S, K+1, V]`` f32
    (the reference's ``_spec_acceptance``, same arguments): returns
    ``(committed [S, K+1], accepted_len [S])`` int64.  Row s commits
    ``committed[s, :accepted_len[s]]``: its accepted drafts, then one
    bonus or correction token, so ``accepted_len`` is 1..K+1; the rest
    of the row is 0."""
    s, k1, v = lg.shape
    k = k1 - 1
    dev = lg.device
    proposals = proposals.long()
    counters = counters.long()
    # every position of a row under the row's filters (expanded, not
    # repeat_interleave: no size to compute, so the graph captures it)
    tprobs = filtered_probs(
        lg.reshape(s * k1, v),
        *(x[:, None].expand(s, k1).reshape(-1)
          for x in (temps, top_ks, top_ps))).reshape(s, k1, v)
    greedy_choice = torch.argmax(lg, dim=-1)
    greedy_ok = proposals == greedy_choice[:, :k]
    q = draft_probs.gather(-1, proposals[..., None])[..., 0]
    p = tprobs[:, :k].gather(-1, proposals[..., None])[..., 0]
    draft_idx = counters[:, None] + torch.arange(k, device=dev)[None, :]
    ukeys = fold_keys(fold_keys(
        keys[:, None, :].expand(s, k, 2), draft_idx), ACCEPT_TAG)
    stochastic_ok = uniform(ukeys) * torch.clamp_min(q, 1e-20) < p
    ok = torch.where((temps > 0)[:, None], stochastic_ok, greedy_ok)
    n = torch.cumprod(ok.long(), dim=1).sum(1)       # accepted drafts 0..K
    # the token at position n: a draw from the residual after a
    # rejection, from the target's distribution after a full accept
    rows = torch.arange(s, device=dev)
    t_at = tprobs[rows, n]
    d_at = torch.cat([draft_probs, draft_probs.new_zeros((s, 1, v))],
                     dim=1)[rows, n]
    resid = torch.clamp_min(t_at - d_at, 0.0)
    rsum = resid.sum(-1, keepdim=True)
    use_resid = (n < k)[:, None] & (rsum > 1e-12)
    dist = torch.where(use_resid, resid / torch.clamp_min(rsum, 1e-20),
                       t_at)
    bkeys = fold_keys(fold_keys(keys, counters + n), BONUS_TAG)
    sampled_bonus = categorical(bkeys, torch.log(dist + 1e-30))
    bonus = torch.where(temps > 0, sampled_bonus, greedy_choice[rows, n])
    pos = torch.arange(k1, device=dev)[None, :]
    padded = torch.cat([proposals, proposals.new_zeros((s, 1))], dim=1)
    committed = torch.where(pos < n[:, None], padded,
                            torch.where(pos == n[:, None], bonus[:, None],
                                        torch.zeros_like(padded)))
    return committed, n + 1


def make_spec_verify_step(model, num_draft, kv_cache_dtype=None, pool=None,
                          fused=None):
    """``step(pending [S], proposals [S, K], draft_probs [S, K, V] f32,
    pools, block_tables [S, max_blocks], lengths [S], temps, top_ks,
    top_ps, keys, counters) -> (committed [S, K+1], accepted_len [S])``:
    the target's forward over ``[pending, d_1 .. d_K]`` at ``lengths``
    (every position written into the pools in place, the model's chunk
    path with an all-true write mask), its f32 logits at all K+1
    positions, then :func:`spec_acceptance`.  A
    :class:`~paddle_tpu_torch.jit.GraphStep` that binds the pools and the
    five per-slot sampling tensors; the proposals and probabilities are
    copied into its static inputs at every call (``pool``: its graph
    memory pool; ``fused`` the serving mode of the forward)."""
    fused = resolve_fused(fused)

    @torch.inference_mode()
    def step(pending, proposals, draft_probs, pools, block_tables, lengths,
             temps, top_ks, top_ps, keys, counters):
        ids = torch.cat([pending[:, None].long(), proposals.long()], dim=1)
        caches = _paged_caches(pools, block_tables, kv_cache_dtype, fused)
        every = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        lg = model(ids, caches, lengths, write_mask=every).float()
        return spec_acceptance(lg, proposals, draft_probs, temps, top_ks,
                               top_ps, keys, counters)

    return GraphStep(step, model.device, bound=(3, 6, 7, 8, 9, 10),
                     pool=pool)
