"""Where the time of the MoE dispatch kernel goes: the source as it is
against copies with one part of the work taken out or one constant
changed.

``csrc/moe_dispatch.cu``'s ``moe_dispatch_kernel`` runs, in each of its
persistent blocks, an index stage (every block streams all T*K choices
and counts those that land in its slots) and then a rows stage (warps
write the block's rows: zeros, or the weighted token rows).  This
script builds the source as it is and copies of it, each with the flags
of ``kernels/_build.py``, into ``build/dispatch_parts/``:

- ``no_index``: no index stage (every row written as zeros);
- ``no_rows``: no rows stage (the index stage alone);
- ``slot_order``: the routed slots in the order the index stage found
  them, not their tokens' order;
- ``no_stream``: plain stores of the output rows, not streaming ones;

and times each with CUDA events at the forms of ``chip_smoke.py``'s
phase 2m (Mixtral's hidden 4096, 8 experts, top-2, bf16: a prefill
chunk's 256 tokens, a training batch's 4096, and 4096 at capacity 1024,
dropping), beside the fill of the [E*C, 4096] buffer with zeros
(``torch.zero_``) and a copy of it (``Tensor.copy_``), the store and
the load-and-store rates the card reaches.  The copies compute wrong
outputs; the source as it is is held against the plain version first.

    python -m paddle_tpu_torch.tools.dispatch_parts [--iters 20]

Prints one line a form and a JSON object as the last line.  Needs one
card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..kernels import _build
from ..kernels import moe_dispatch as md
from ..models.llama import route_top_k
from .fused_linear_parts import time_ms, variant_source

LIB = "moe_dispatch"
VARIANTS = {
    "as_is": (),
    "no_index": (("for (int base = 0; base < n;",
                  "for (int base = n; base < n;"),),
    "no_rows": (("item < nl * chunks;", "item < 0;"),
                ("item < len * chunks;", "item < 0;")),
    "slot_order": (("write(order[item / chunks]",
                    "write(listed[item / chunks]"),),
    "no_stream": (("if constexpr (sizeof(Pack<T, VEC>) == 16)",
                   "if constexpr (false)"),),
}
# (tag, T, C, skew of expert 0's router logit)
FORMS = (("chunk", 256, 256, 0.0), ("train", 4096, 4096, 0.0),
         ("drop", 4096, 1024, 1.5))
HID, E, K = 4096, 8, 2


def build_variants() -> dict:
    """{variant: path of its library}, all built at once."""
    src = (_build.CSRC / f"{LIB}.cu").read_text()
    return _build.build_copies(
        LIB, {name: variant_source(src, changes)
              for name, changes in VARIANTS.items()},
        _build.BUILD_DIR.parent / "dispatch_parts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_parts: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    g = torch.Generator(device=dev).manual_seed(3)
    results = []
    for tag, T, C, skew in FORMS:
        logits = torch.randn((T, E), generator=g, device=dev)
        logits[:, 0] += skew
        eidx, sidx, gate = route_top_k(logits, K, torch.bfloat16)
        tok = torch.randn((T, HID), generator=g, device=dev).bfloat16()
        ones = torch.ones_like(gate)
        _build.use_library(LIB, libs["as_is"])
        if not torch.equal(md.moe_dispatch(tok, eidx, sidx, ones, E, C),
                           md.dispatch_plain(tok, eidx, sidx, ones, E, C)):
            raise AssertionError(f"{tag}: the kernel differs from its plain "
                                 "version")
        buf = torch.empty((E * C, HID), dtype=torch.bfloat16, device=dev)
        src = torch.randn((E * C, HID), generator=g, device=dev).bfloat16()
        row = dict(form=tag, T=T, C=C,
                   zero_ms=time_ms(buf.zero_, args.iters),
                   copy_ms=time_ms(lambda: buf.copy_(src), args.iters))
        del src
        for name, path in libs.items():
            _build.use_library(LIB, path)
            row[name] = time_ms(lambda: md.moe_dispatch(
                tok, eidx, sidx, ones, E, C), args.iters)
        results.append(row)
        print(f"{tag:5s} T={T} C={C}: " + ", ".join(
            f"{k} {row[k]:.4f}" for k in ("zero_ms", "copy_ms", *libs))
            + " ms", flush=True)
    _build.use_library(LIB, libs["as_is"])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
