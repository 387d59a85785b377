"""Stress the TMA rings of the bf16 fused_norm_linear kernels and tell
which part of a consumer's stage release keeps them right.

Both bf16 kernels of ``csrc/fused_norm_linear.cu`` stream w (and, in the
tiled one, x) through a ring of shared-memory stages that TMA refills;
consumer warps read a stage with ldmatrix and then free it with::

    fence_proxy_async();   // their reads (generic proxy) before the
    __syncwarp();          // refill (async proxy); every lane's reads
    if (lane == 0) mbar_arrive(&empty[s]);   // before lane 0 frees it

A refill that lands under the reads gives a wrong sum, not a hang, so
only many launches show it.  This script builds the source as it is and
three copies with a part of that sequence taken out (``fence_only``:
no ``__syncwarp``; ``syncwarp_only``: no fence; ``neither``), each with
the flags of ``kernels/_build.py``, into ``build/ring_stress/``.  For
each library it launches Llama-3-8B's q/k/v and gate/up groups at the
decode step's M = 8 (``norm_linear_skinny_mma``, at the wrapper's K
split) and at a prefill chunk's M = 256 (``norm_linear_wgmma``),
alternating the two groups, ``--launches`` times each, and counts the
launches whose outputs differ by any bit from a reference: the first
launch of the source as it is, held against the plain version within
one bf16 rounding.  It also times each group with CUDA events.

    python -m paddle_tpu_torch.tools.ring_stress [--launches 10000]

Prints one line a (library, rows) and a JSON object as the last line.
Needs one card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..kernels import _build
from ..kernels import fused_norm_linear as fnl

LIB = "fused_norm_linear"
FENCE, SYNC = "fence_proxy_async();", "__syncwarp();"
# the lines each variant takes out of every stage release
VARIANTS = {"as_is": (), "fence_only": (SYNC,), "syncwarp_only": (FENCE,),
            "neither": (FENCE, SYNC)}
RELEASE_SITES = 2         # norm_linear_wgmma's and norm_linear_skinny_mma's
HID, FFN, H, KVH, D = 4096, 14336, 32, 8, 128
GROUPS = {"qkv": ([H * D, KVH * D, KVH * D], ["none"] * 3),
          "gate_up": ([FFN, FFN], ["silu", "none"])}


def variant_source(src: str, drop) -> str:
    """``src`` with the lines in ``drop`` taken out of each stage
    release (the lines just before a lane-0 ``mbar_arrive(&empty[``)."""
    lines = src.split("\n")
    sites = [i for i, ln in enumerate(lines)
             if "lane == 0" in ln and "mbar_arrive(&empty[" in ln]
    if len(sites) != RELEASE_SITES:
        raise RuntimeError(f"{len(sites)} stage releases in {LIB}.cu, "
                           f"not {RELEASE_SITES}")
    cut = set()
    for i in sites:
        if [lines[i - 2].strip(), lines[i - 1].strip()] != [FENCE, SYNC]:
            raise RuntimeError(f"{LIB}.cu:{i + 1}: the release is not "
                               f"{FENCE} {SYNC} arrive")
        cut.update(j for j in (i - 2, i - 1) if lines[j].strip() in drop)
    return "\n".join(ln for j, ln in enumerate(lines) if j not in cut)


def build_variants() -> dict:
    """{variant: path of its library}, all built at once."""
    src = (_build.CSRC / f"{LIB}.cu").read_text()
    return _build.build_copies(
        LIB, {name: variant_source(src, drop)
              for name, drop in VARIANTS.items()},
        _build.BUILD_DIR.parent / "ring_stress")


def use_library(path):
    """Route the wrappers' fused_norm_linear calls to ``path``."""
    _build.use_library(LIB, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=10000,
                    help="launches of each group a (library, rows)")
    ap.add_argument("--time-iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_stress: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()

    nw = (1 + 0.1 * torch.randn(HID, generator=g, device=dev)).bfloat16()
    ws = {k: [randn(HID, n, std=HID ** -0.5) for n in ns]
          for k, (ns, _) in GROUPS.items()}
    xs = {M: randn(M, HID, std=3.0) for M in (8, 256)}
    rss = {M: fnl.rms_scale(x, 1e-5) for M, x in xs.items()}

    def run(M, grp):
        return fnl.fused_norm_linear_group(xs[M], rss[M], nw, ws[grp],
                                           GROUPS[grp][1])

    # the reference bits: the source as it is, against the plain version
    use_library(libs["as_is"])
    refs = {}
    for M in xs:
        for grp, (_, acts) in GROUPS.items():
            refs[M, grp] = run(M, grp)
            for o, w, a in zip(refs[M, grp], ws[grp], acts):
                want = fnl.fused_norm_linear_plain(xs[M], rss[M], nw, w, a)
                err = float((o.float() - want.float()).abs().max())
                if err > float(want.float().abs().max()) / 128:
                    raise AssertionError(f"M={M} {grp}: max error {err}")

    results = []
    dev_name = torch.cuda.get_device_name(0)
    for name, path in libs.items():
        use_library(path)
        for M in xs:
            bad = torch.zeros(len(GROUPS), dtype=torch.int64, device=dev)
            for _ in range(args.launches):
                for gi, grp in enumerate(GROUPS):
                    outs = run(M, grp)
                    diff = torch.stack([(o != r).any() for o, r in
                                        zip(outs, refs[M, grp])]).any()
                    bad[gi] += diff
            counts = dict(zip(GROUPS, bad.tolist()))
            times = {}
            for grp in GROUPS:
                for _ in range(10):
                    run(M, grp)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(args.time_iters):
                    run(M, grp)
                e1.record()
                torch.cuda.synchronize()
                times[grp] = e0.elapsed_time(e1) / args.time_iters
            kernel = "skinny" if M <= fnl.SKINNY_MAX_ROWS else "tiled"
            row = dict(library=name, M=M, kernel=kernel,
                       launches=args.launches, wrong=counts, ms=times)
            results.append(row)
            print(f"{name:14s} M={M:3d} ({kernel}): wrong launches "
                  f"{counts} of {args.launches} each; ms a group "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
                  flush=True)
    print(json.dumps({"device": dev_name, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
