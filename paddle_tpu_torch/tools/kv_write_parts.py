"""Where the time of the KV write kernel goes: the source as it is
against copies with one part of its work taken out.

``csrc/kv_quant.cu``'s ``kv_write_kernel`` looks up each token's pool
row, loads its k or v row (a decode step's k rotated), and writes it as
it is or, for an int8 / fp8 pool, as codes with the row's absmax scale.
This script builds the source as it is and copies of it, each with the
flags of ``kernels/_build.py``, into ``build/kv_write_parts/``:

- ``no_max``: no absmax reduction across the block (the scale of the
  thread's own values);
- ``no_div``: the codes of x * scale, not x / scale (no IEEE division);
- ``no_encode``: the values truncated to int8, not encoded;

and times each with CUDA events at ``chip_smoke.py`` phase 2's shapes
of one Llama-3-8B layer (8 kv heads of 128): a decode step of 8
sequences and a 256-token prefill chunk, into bf16, int8 and fp8 pools.
The copies compute wrong codes; the source as it is is held against the
plain version first.

    python -m paddle_tpu_torch.tools.kv_write_parts [--iters 20]

Prints one line a (form, pool) and a JSON object as the last line.
Needs one card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..kernels import _build
from ..kernels import kv_quant as kvq
from .fused_linear_parts import time_ms, variant_source

LIB = "kv_quant"
VARIANTS = {
    "as_is": (),
    "no_max": (("amax = block_max<KW_THREADS>(amax);", ""),),
    "no_div": (("encode_code<Q>(x[e] / scale)",
                "encode_code<Q>(x[e] * scale)"),),
    "no_encode": (("encode_code<Q>(x[e] / scale)", "(int8_t)(x[e] / scale)"),),
}
KVH, D, BS, NB = 8, 128, 16, 1 + 8 * 64


def build_variants() -> dict:
    """{variant: path of its library}, all built at once."""
    src = (_build.CSRC / f"{LIB}.cu").read_text()
    return _build.build_copies(
        LIB, {name: variant_source(src, changes)
              for name, changes in VARIANTS.items()},
        _build.BUILD_DIR.parent / "kv_write_parts")


def operands(form, pool, g, dev):
    """kv_write's (args, keywords): 8 sequences of 64 blocks, a decode
    step at positions 100 + 70 b (k with its RoPE rows), or 256 tokens
    of the first sequence from position 768."""
    dtype = torch.bfloat16
    scheme = None if pool == "bf16" else pool
    bt = (1 + torch.randperm(NB - 1, generator=g, device=dev)).view(8, 64) \
        .int()
    if form == "decode":
        B, T = 8, 1
        pos = (torch.arange(8, device=dev) * 70 + 100).int()
        ang = pos[:, None].double() * 0.37 ** torch.arange(D // 2, device=dev)
        kw = dict(c=ang.cos().to(dtype), s=ang.sin().to(dtype))
    else:
        B, T = 1, 256
        bt, pos = bt[:1].contiguous(), torch.tensor([768], dtype=torch.int32,
                                                    device=dev)
        kw = dict(write_mask=torch.ones((1, T), dtype=torch.bool,
                                        device=dev))
    k, v = (torch.randn((B, T, KVH, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    if scheme is None:
        pools = [torch.zeros((NB, BS, KVH, D), dtype=dtype, device=dev)
                 for _ in range(2)]
    else:
        pools = [torch.zeros((NB, BS, KVH, D), dtype=torch.int8, device=dev)
                 for _ in range(2)]
        kw.update(k_scale=torch.ones((NB, BS), device=dev),
                  v_scale=torch.ones((NB, BS), device=dev))
    kw["scheme"] = scheme
    return [*pools, k, v, bt, pos], kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kv_write_parts: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    g = torch.Generator(device=dev).manual_seed(4)
    results = []
    for form in ("decode", "chunk"):
        for pool in ("bf16", "int8", "fp8"):
            ops, kw = operands(form, pool, g, dev)
            _build.use_library(LIB, libs["as_is"])
            want = [x.clone() for x in ops]
            wkw = {k: x.clone() if isinstance(x, torch.Tensor) else x
                   for k, x in kw.items()}
            kvq.kv_write(*ops, **kw)
            kvq.kv_write_plain(*want, **wkw)
            if not all(torch.equal(a, b) for a, b in zip(ops[:2], want[:2])):
                raise AssertionError(f"{form} {pool}: the kernel differs "
                                     "from its plain version")
            row = dict(form=form, pool=pool)
            for name, path in libs.items():
                _build.use_library(LIB, path)
                row[name] = time_ms(lambda: kvq.kv_write(*ops, **kw),
                                    args.iters)
            results.append(row)
            print(f"{form:6s} {pool:4s}: " + ", ".join(
                f"{k} {row[k]:.4f}" for k in libs) + " ms", flush=True)
    _build.use_library(LIB, libs["as_is"])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
