"""``chip_smoke.py`` phase 6r (d)'s trace replayed on the CPU, with each
replica's chunk and decode EWMAs fed fixed step times in place of the
card's, to see where the router places it and what the prefix caches
then serve, before (or beside) a chip run:

    python -m paddle_tpu_torch.tools.replay_placement \\
        [--vocab 128256] [--chunk-ms 12.0] [--decode-ms 7.8] \\
        [--jitter 0.0] [--weights 3 8] [--seeds 0]

The model is ``LlamaConfig.tiny`` in f32 at ``--vocab`` tokens (the
trace's token ids need that many rows); placement and scheduling do
not read its numbers: the router reads the EWMAs, which take
``--chunk-ms`` / ``--decode-ms`` (each observation scaled by a uniform
factor in 1 ± ``--jitter``), and the engines schedule in iterations.
Prints, for each trace seed, round-robin's cached-token ratio and
placements, then affinity's at each ``--weights``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _fix_ewmas(eng, chunk_s, decode_s, jitter, rng):
    ov = eng.overload
    for ewma, value in ((ov.chunk_ewma, chunk_s), (ov.decode_ewma,
                                                   decode_s)):
        observe = ewma.observe

        def fixed(dt, compiled=None, observe=observe, value=value):
            observe(value * (1.0 + jitter * rng.uniform(-1.0, 1.0)),
                    compiled)
        ewma.observe = fixed


def main(argv=None) -> int:
    import chip_smoke as cs
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (Engine, Router, ServingConfig,
                                          Tenant, build_trace, replay_trace)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vocab", type=int, default=128256)
    ap.add_argument("--chunk-ms", type=float, default=12.0)
    ap.add_argument("--decode-ms", type=float, default=7.8)
    ap.add_argument("--jitter", type=float, default=0.0)
    ap.add_argument("--weights", type=float, nargs="+", default=[3.0, 8.0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    tenants = [Tenant(name, kind=kind, requests=n, shared_prefix_tokens=sh,
                      tail_tokens=tail, max_new_tokens=new, **samp)
               for name, kind, n, sh, tail, new, samp in cs.REPLAY_TENANTS]
    rng = np.random.RandomState(0)
    for seed in args.seeds:
        trace = build_trace(tenants, seed=seed, horizon=cs.REPLAY_HORIZON,
                            vocab=args.vocab)
        longest = max(len(a.prompt) + a.max_new_tokens for a in trace)
        blocks = 1 + sum(-(-(len(a.prompt) + a.max_new_tokens)
                           // cs.MAIN_BS) for a in trace) + 8
        model = LlamaForCausalLM(LlamaConfig.tiny(
            vocab_size=args.vocab, max_position_embeddings=longest),
            device="cpu", seed=0)
        print(f"trace seed {seed}: {len(trace)} arrivals, "
              f"{sum(len(a.prompt) for a in trace)} prompt tokens",
              flush=True)
        runs = [("round_robin", cs.REPLAY_AFFINITY_WEIGHT)] + \
            [("affinity", w) for w in args.weights]
        for policy, weight in runs:
            engines = [Engine(model, ServingConfig(
                name=f"replica-{i}", max_batch_size=8,
                block_size=cs.MAIN_BS, chunk_tokens=256, num_blocks=blocks,
                max_queue_len=48)) for i in range(2)]
            for eng in engines:
                _fix_ewmas(eng, args.chunk_ms / 1e3, args.decode_ms / 1e3,
                           args.jitter, rng)
            fleet = replay_trace(Router(engines, policy=policy, seed=0,
                                        affinity_weight=weight),
                                 trace)["fleet"]
            print(f"  {policy} (weight {weight}): cached-token ratio "
                  f"{fleet['cached_token_ratio']}, placements "
                  f"{fleet['placements']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
