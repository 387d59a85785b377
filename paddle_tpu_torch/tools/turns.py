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
(2), ``train_kernels`` (3), ``moe_kernels`` (2m), ``c1_kernels`` (2c),
``static_kernels`` (2s), ``sampler`` (2d), ``main`` (6, bf16 serving,
and 6s, the same requests sampled and streamed, 6g, the CUDA graphs
against their eager functions, 6o, overload control, and 6sp,
speculative decoding, where the checkout has them),
``main_graphs`` (6g alone, on a model of its own), ``spec_main`` (6's
greedy run, then 6sp),
``main_quant`` (6 from quantized pools; runs ``main`` first for its pool
size when it is not named), ``tiny_c1`` (4c), ``c1_main`` (6c),
``phi3_main`` (6p), ``moe_main`` (6m), ``train_phi3`` (7c); a checkout
whose ``chip_smoke.py`` lacks a phase skips it, except ``train_phi3``
and ``phi3_main``, which such a checkout runs from this tool's own
``chip_smoke.py`` over its own package, expecting the launches its own
routes give (``attention_counters``; ``_serve_main``'s counts, without
6p's instance checks), so that the step time of an older package is
measured at the same shape.  Each phase prints what ``chip_smoke.py``
prints:
every profiled step its kernel count and kernel time, every serving run
a digest of its greedy tokens, to compare the checkouts' tokens (a
checkout whose ``chip_smoke.py`` predates those lines prints neither).
Output: each process's lines, each prefixed with its turn and
directory.  Exits with the first failing turn's code.

Every serving run also leaves its greedy tokens in a directory the
turns share (``--tokens``, ``build/turns_tokens/`` by default), and
compares them with those an earlier turn of another checkout left for
the same run: for each request whose tokens differ it prints the first
differing token and the top-2 logit margin of the logits each checkout
took that token from (the engine's own prefill or decode step; the two
checkouts agree on every earlier token), each against the bf16
tolerance at that token, two bf16 ulps of its top logit (nan for a
token of a sampled decode step, which returns no logits).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

PHASES = ("kernels", "train_kernels", "moe_kernels", "c1_kernels",
          "static_kernels", "sampler", "main", "main_graphs", "main_quant",
          "spec_main", "tiny_c1", "c1_main", "phi3_main", "moe_main",
          "train_phi3")

CHILD = """
import hashlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch
import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
print(cs.smi_line(), flush=True)
from paddle_tpu_torch.serving import Engine

TOKENS = Path(os.environ["TURNS_TOKENS"])
ME = hashlib.sha1(os.getcwd().encode()).hexdigest()[:8]
serve, submitted = cs._serve_main, []
init, submit = Engine.__init__, Engine.submit
prefill_chunk, decode_iteration = Engine._prefill_chunk, \
    Engine._decode_iteration


def stash(eng, step):
    def call(*args):
        eng.turns_logits = step(*args)
        return eng.turns_logits
    return call


def init_(self, *args, **kwargs):
    init(self, *args, **kwargs)
    self._decode_step = stash(self, self._decode_step)
    self._prefill_step = stash(self, self._prefill_step)


def submit_(self, *args, **kwargs):
    req = submit(self, *args, **kwargs)
    req.turns_top2 = []
    submitted.append(req)
    return req


def top2(logits):
    return torch.topk(logits.float(), 2, dim=-1).values.cpu().tolist()


def prefill_chunk_(self, req):
    n = len(req.generated)
    prefill_chunk(self, req)
    if len(req.generated) > n:      # the first token, from this chunk
        req.turns_top2.append(top2(self.turns_logits[0]))


def decode_iteration_(self):
    active = [(r, r.slot) for r in self._slots
              if r is not None and r.state == "running"]
    self.turns_logits = None
    decode_iteration(self)
    if active:
        # a sampled step returns tokens, not logits: no margin for them
        rows = top2(self.turns_logits) if self.turns_logits is not None \
            else [None] * len(self._slots)
        for r, slot in active:
            r.turns_top2.append(rows[slot])


def margin(pair):
    if pair is None:
        return float("nan"), float("nan")
    top, second = pair
    ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
    return top - second, 2 * ulp


def compared(model, prompts, tag, *args, **kwargs):
    submitted.clear()
    out, counts, eng = serve(model, prompts, tag, *args, **kwargs)
    mine = [[int(t) for t in r.generated] for r in submitted]
    tops = [r.turns_top2 for r in submitted]
    run = TOKENS / tag.replace(" ", "_").replace("(", "").replace(")", "")
    run.mkdir(parents=True, exist_ok=True)
    for other in sorted(run.glob("*.json")):
        if other.stem == ME:
            continue
        got = json.loads(other.read_text())
        for i, (a, b) in enumerate(zip(mine, got["tokens"])):
            if a == b:
                continue
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            (m_here, tol_here), (m_there, tol_there) = \
                margin(tops[i][j]), margin(got["top2"][i][j])
            print(f"  {tag}: request {i} token {j} differs (here {a[j]}, "
                  f"{got['root']} {b[j]}); top-2 margin of the logits each "
                  f"took it from: here {m_here:.4e} (bf16 tolerance "
                  f"{tol_here:.4e}: {'within' if m_here < tol_here else 'EXCEEDS'}"
                  f"), there {m_there:.4e} (tolerance {tol_there:.4e}: "
                  f"{'within' if m_there < tol_there else 'EXCEEDS'})",
                  flush=True)
        same = sum(a == b for a, b in zip(mine, got["tokens"]))
        print(f"  {tag}: {same} of {len(mine)} requests' tokens equal to "
              f"{got['root']}'s", flush=True)
    (run / f"{ME}.json").write_text(json.dumps(
        {"root": os.getcwd(), "tokens": mine, "top2": tops}))
    return out, counts, eng


Engine.__init__, Engine.submit = init_, submit_
Engine._prefill_chunk, Engine._decode_iteration = prefill_chunk_, \
    decode_iteration_
cs._serve_main = compared
cs.phase_build()
phases = sys.argv[1:]
blocks = None
for phase in phases:
    if phase == "main_quant" and blocks is None:
        blocks = cs.phase_main(dev)[1]
        cs.free()
    if phase == "main":
        blocks = cs.phase_main(dev)[1]
    elif phase == "main_quant":
        cs.phase_main_quant(dev, blocks)
    elif hasattr(cs, "phase_" + phase):
        getattr(cs, "phase_" + phase)(dev)
    elif phase in ("train_phi3", "phi3_main"):
        spec = importlib.util.spec_from_file_location(
            "turns_smoke", os.environ["TURNS_SMOKE"])
        new = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(new)
        if phase == "phi3_main":
            new._serve_main = compared
            new.phase_phi3_main(dev, strict=False)
        else:
            cfg = new.phi3_mini_config(num_hidden_layers=new.PHI3_LAYERS)
            new.phase_train_phi3(dev, new.attention_counters(cfg,
                                                             new.PHI3_T))
    else:
        print(f"no phase {phase} in this checkout", flush=True)
    cs.free()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES, required=True)
    ap.add_argument("--tokens", default="build/turns_tokens",
                    help="directory of the serving runs' greedy tokens")
    ap.add_argument("roots", nargs="+",
                    help="checkouts to run, in this order")
    args = ap.parse_args(argv)
    env = dict(os.environ, TURNS_TOKENS=os.path.abspath(args.tokens),
               TURNS_SMOKE=str(Path(__file__).resolve().parents[2] /
                               "chip_smoke.py"))
    rc = 0
    for turn, root in enumerate(args.roots, 1):
        tag = f"[turn {turn} {root}]"
        print(f"{tag} phases {' '.join(args.phases)}", flush=True)
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, *args.phases],
            cwd=os.path.abspath(root), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(f"{tag} {line}", end="", flush=True)
        code = proc.wait()
        print(f"{tag} exit {code}", flush=True)
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
