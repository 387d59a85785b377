"""Run phases of ``chip_smoke.py`` from several checkouts in turns, on one
card, to compare two versions of the port within one call:

    python -m paddle_tpu_torch.tools.turns --phases moe_kernels main \\
        main_quant -- OLD . . OLD

Each checkout (a directory holding ``chip_smoke.py`` and
``paddle_tpu_torch``; an unpacked ``git archive`` of another commit,
say) runs in a Python process of its own, started from that directory,
so that its own ``chip_smoke.py`` and package are the ones imported and
its kernels are built into its own ``build/``.  The process builds every
kernel (phase 1) and then runs the named phases in order: ``kernels``
(2), ``train_kernels`` (3), ``moe_kernels`` (2m), ``static_kernels``
(2s), ``main`` (6, bf16 serving), ``main_quant`` (6 from quantized
pools; runs ``main`` first for its pool size when it is not named),
``moe_main`` (6m).  Each phase prints what ``chip_smoke.py`` prints:
every profiled step its kernel count and kernel time, every serving run
a digest of its greedy tokens, to compare the checkouts' tokens (a
checkout whose ``chip_smoke.py`` predates those lines prints neither).
Output: each process's lines, each prefixed with its turn and
directory.  Exits with the first failing turn's code.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

PHASES = ("kernels", "train_kernels", "moe_kernels", "static_kernels",
          "main", "main_quant", "moe_main")

CHILD = """
import sys
import torch
import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
print(cs.smi_line(), flush=True)
cs.phase_build()
phases = sys.argv[1:]
blocks = None
for phase in phases:
    if phase == "main_quant" and blocks is None:
        _, blocks = cs.phase_main(dev)
        cs.free()
    if phase == "main":
        _, blocks = cs.phase_main(dev)
    elif phase == "main_quant":
        cs.phase_main_quant(dev, blocks)
    else:
        getattr(cs, "phase_" + phase)(dev)
    cs.free()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES, required=True)
    ap.add_argument("roots", nargs="+",
                    help="checkouts to run, in this order")
    args = ap.parse_args(argv)
    rc = 0
    for turn, root in enumerate(args.roots, 1):
        tag = f"[turn {turn} {root}]"
        print(f"{tag} phases {' '.join(args.phases)}", flush=True)
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, *args.phases],
            cwd=os.path.abspath(root), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(f"{tag} {line}", end="", flush=True)
        code = proc.wait()
        print(f"{tag} exit {code}", flush=True)
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
