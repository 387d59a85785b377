"""Where the time of fused_linear's bf16 wgmma instance goes: the source
as it is against copies with one part of the work taken out.

``csrc/fused_linear.cu``'s ``fused_linear_wgmma`` multiplies (TMA loads
of x and w, wgmma) and then runs its epilogue (the bias, the activation,
the rounding and the TMA stores of the output).  This script builds the
source as it is and three copies, each with the flags of
``kernels/_build.py``, into ``build/fused_linear_parts/``:

- ``no_store``: the epilogue without its TMA stores;
- ``no_epilogue``: no epilogue at all (the loads and the products);
- ``no_products``: no wgmma (the loads and the epilogue);

and times each with CUDA events at BERT-base's FFN and MLM shapes
(x [16384, 768], w [3072 or 768, 768], a bias) for every activation,
beside one PyTorch call that computes the same function (the activation
of ``F.linear``).  The copies compute wrong outputs; the source as it is
is held against the plain version first.

    python -m paddle_tpu_torch.tools.fused_linear_parts [--iters 50]

Prints one line a (shape, activation) and a JSON object as the last
line.  Needs one card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels import fused_linear as fl

LIB = "fused_linear"
_NO_WGMMA = 'asm volatile("" ::"l"(da), "l"(dw));'
# the lines each copy changes: (text as in the source, its replacement)
VARIANTS = {
    "as_is": (),
    "no_store": (("tma_store_2d(map, buf, n0, m0);",
                  "if (n0 < 0) tma_store_2d(map, buf, n0, m0);"),),
    "no_epilogue": (("store_chunk<ACT>(acc + 32 * c,",
                     "if (M < 0) store_chunk<ACT>(acc + 32 * c,"),),
    "no_products": (("wgmma_ss_n256<0>(acc, da, dw, 1);", _NO_WGMMA),
                    ("wgmma_ss_n128<0>(acc, da, dw, 1);", _NO_WGMMA)),
}
SHAPES = {"ffn": (16384, 768, 3072), "mlm": (16384, 768, 768)}
LIBRARY = {"none": lambda z: z, "relu": torch.relu, "gelu": F.gelu,
           "gelu_tanh": lambda z: F.gelu(z, approximate="tanh"),
           "silu": F.silu}


def variant_source(src: str, changes) -> str:
    """``src`` with each (old, new) of ``changes`` applied; each ``old``
    must be in the source exactly once."""
    for old, new in changes:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} found {src.count(old)} times in "
                               "the source, not once")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """{variant: path of its library}, all built at once."""
    src = (_build.CSRC / f"{LIB}.cu").read_text()
    return _build.build_copies(
        LIB, {name: variant_source(src, changes)
              for name, changes in VARIANTS.items()},
        _build.BUILD_DIR.parent / "fused_linear_parts")


def use_library(path):
    """Route the wrapper's fused_linear calls to ``path``."""
    _build.use_library(LIB, path)


def time_ms(fn, iters) -> float:
    """Device time of one ``fn()``: CUDA events around ``iters`` calls
    enqueued while a sleep kernel holds the stream."""
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_linear_parts: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for tag, (M, K, N) in SHAPES.items():
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        w = (torch.randn(N, K, generator=g, device=dev) / K ** 0.5
             ).bfloat16()
        b = (0.1 * torch.randn(N, generator=g, device=dev)).bfloat16()
        if not fl.tma_ok(x, w):
            raise AssertionError(f"{tag}: not the wgmma instance")
        use_library(libs["as_is"])
        for act in fl.ACTIVATIONS:
            got = fl.fused_linear(x, w, b, act)
            want = fl.fused_linear_plain(x, w, b, act).float()
            err = float((got.float() - want).abs().max())
            if err > float(want.abs().max()) / 128:
                raise AssertionError(f"{tag} {act}: max error {err}")
        for act in fl.ACTIVATIONS:
            row = dict(shape=tag, M=M, K=K, N=N, activation=act,
                       library_ms=time_ms(
                           lambda: LIBRARY[act](F.linear(x, w, b)),
                           args.iters))
            for name, path in libs.items():
                use_library(path)
                row[name] = time_ms(lambda: fl.fused_linear(x, w, b, act),
                                    args.iters)
            results.append(row)
            print(f"{tag} {act:9s} " + ", ".join(
                f"{k} {row[k]:.4f}" for k in ("library_ms", *libs))
                + " ms", flush=True)
    use_library(libs["as_is"])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
