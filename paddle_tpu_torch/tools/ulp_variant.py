"""Copy a checkout of the port and change only how its RMSNorm row scale
rounds, to measure how far greedy tokens move when ``rsqrt(mean(x^2) +
eps)`` moves by an f32 ulp or two:

    python -m paddle_tpu_torch.tools.ulp_variant SRC DST
    python -m paddle_tpu_torch.tools.turns --phases main moe_main -- SRC DST

The copy takes the plain row scale's mean in float64 (rounded once to
f32, where float32 ``mean`` rounds each partial sum) and computes the
CUDA kernel's rsqrt as an IEEE ``1 / sqrt`` (where ``rsqrtf`` is the
approximate instruction).  Every other line is the source's, so two
turns of ``tools.turns`` over SRC and DST show the tokens and the top-2
margins that rounding alone changes.  Raises if a checkout has neither
line to change.
"""
from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

# (file, the source's text, the variant's): the plain row scale, in
# kernels/rms_norm.py or (older checkouts) kernels/fused_norm_linear.py,
# and the kernel's rsqrt
PLAIN = ("var = x.float().square().mean(-1, keepdim=True)",
         "var = x.double().square().mean(-1, keepdim=True).float()")
KERNEL = ("rsqrtf(", "1.f / sqrtf(")


def make(src: Path, dst: Path) -> dict:
    """Copy ``src`` to ``dst`` (without its build directory) and change
    the row scale's rounding there; returns {file: replacements}."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "build", ".git", "__pycache__"))
    pkg = dst / "paddle_tpu_torch"
    changed = {}
    for rel, (old, new) in (("kernels/rms_norm.py", PLAIN),
                            ("kernels/fused_norm_linear.py", PLAIN),
                            ("csrc/rms_norm.cu", KERNEL)):
        path = pkg / rel
        text = path.read_text()
        if old in text:
            changed[rel] = text.count(old)
            path.write_text(text.replace(old, new))
    if not any(k.endswith(".py") for k in changed) or \
            "csrc/rms_norm.cu" not in changed:
        raise RuntimeError(f"ulp_variant: {src} lacks the lines to change "
                           f"(changed {changed})")
    return changed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)
    print(f"ulp_variant: {make(Path(args.src), Path(args.dst))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
