"""Phase 2c's attention rows of ``chip_smoke.py`` (one card), with each
bf16 output's worst row under ``hold_bf16_attention``'s row rule and
SDPA's backward held to the same rule on the same inputs:

    python -m paddle_tpu_torch.tools.attention_rule

Runs phase 1 (the build) and phase 2c with ``hold_bf16_attention``
wrapped: for every output it prints a line ``RULE <name>: worst ratio
<r> at [batch, head, row] ...`` with the number of rows above 0.9 of
their tolerance, that row's largest reference value, the kernel's and
the bf16 plain version's error there and the row's tolerance; for dQ,
dK and dV also SDPA's (``F.scaled_dot_product_attention``'s backward on
the same bf16 inputs) worst ratio under the rule.  A row over 1.0 is
reported and the run goes on.  Exits 1 without a card.
"""
from __future__ import annotations

import sys

import torch


def _rule(got, plain, ref, cancels):
    """The per-row ratios of ``chip_smoke.hold_bf16_attention``, with the
    errors and tolerances they come from."""
    diff = (got.float() - ref).abs()
    pdiff = (plain.float() - ref).abs()
    top = float(ref.abs().max())
    row_tol = 2 * pdiff.amax(-1) + ref.abs().amax(-1).clamp_min(
        top * 2.0 ** -8) * 2.0 ** (-7 if cancels else -8)
    return diff.amax(-1) / row_tol, diff, pdiff, row_tol, top


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_rule: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import flash_attention as fa

    sdpa_grads = {}
    hold, bwd_plain = cs.hold_bf16_attention, fa.flash_bwd_plain

    def probe(name, got, plain, ref, cancels=False):
        ratio, diff, pdiff, row_tol, top = _rule(got, plain, ref, cancels)
        at = tuple(int(i) for i in torch.unravel_index(
            ratio.flatten().argmax(), ratio.shape))
        key = name.split()[-1]
        line = (f"RULE {name}: worst ratio {float(ratio.max()):.4f} at "
                f"{list(at)}; rows over 0.9: {int((ratio > 0.9).sum())} of "
                f"{ratio.numel()}; row max {float(ref[at].abs().max()):.4e} "
                f"(top {top:.4e}); kernel row err "
                f"{float(diff[at].max()):.4e}, plain row err "
                f"{float(pdiff[at].max()):.4e}, row tol "
                f"{float(row_tol[at]):.4e}")
        if key in sdpa_grads:
            s = _rule(sdpa_grads[key], plain, ref, cancels)[0]
            line += (f"; SDPA worst {float(s.max()):.4f}, rows over 0.9: "
                     f"{int((s > 0.9).sum())}")
        print(line, flush=True)
        try:
            return hold(name, got, plain, ref, cancels)
        except AssertionError as e:
            print(f"RULE   over the rule: {e}", flush=True)
            return float(diff.max())

    def plain_bwd(q, k, v, o, lse, do, causal, scale):
        if q.dtype == torch.bfloat16:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 is_causal=causal,
                                                 scale=scale)
            sdpa_grads.update(zip(("dq", "dk", "dv"), torch.autograd.grad(
                out, (qg, kg, vg), do)))
        return bwd_plain(q, k, v, o, lse, do, causal, scale)

    cs.hold_bf16_attention, fa.flash_bwd_plain = probe, plain_bwd
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        cs.phase_build()
        cs.phase_c1_kernels(torch.device("cuda"))
    finally:
        cs.hold_bf16_attention, fa.flash_bwd_plain = hold, bwd_plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
