"""Faults planted in copies of the package, each trained as a world of
phase 7d (``chip_smoke.py``) and held to the unsharded run by 7d's own
comparison (``mesh_train.against_single``): the check that this
comparison refuses a world whose gradients or updates are wrong.

The unsharded run of the arguments after ``--`` comes first
(``OUT/single``, ``OUT/ref.pt``).  Then, for the package as it is
(``as_is``) and for each fault of :data:`FAULTS`, the package is copied
to ``OUT/<name>/paddle_tpu_torch`` with the fault's line replaced (its
text must occur once), the built kernels (``build/paddle_tpu_torch``)
linked in beside it, and ``mesh_train`` run from the copy over
``--axes`` and ``--backend`` by the port's launcher, a rank each place
of the mesh.  ``as_is`` must pass the comparison and every fault must
fail it; a world that does not run to its end is reported as such,
never as refused::

    python -m paddle_tpu_torch.tools.mesh_controls --axes '{"data": 2, \\
        "fsdp": 2, "tp": 2}' --backend gloo --out build/mesh_controls \\
        -- --config llama3_8b --layers 4 --seq 2048 --device cuda:0

The faults of a dense config are :data:`DENSE`; those of an expert-
parallel one (``--config mixtral`` or ``tiny_moe``: phase 7e's
comparison) are :data:`EXPERT`; ``--faults a,b`` picks others::

    python -m paddle_tpu_torch.tools.mesh_controls --axes '{"data": 2, \
        "fsdp": 2, "expert": 2}' --backend gloo --out build/ep_controls \
        -- --config mixtral --layers 1 --seq 1024 --device cuda:0

Phase 7q's program (``mesh_train --sp-modes``) takes the faults of
:data:`SEQUENCE` and its own comparison (``mesh_train.sp_against_single``
over the ring, Ulysses and sequence-parallel modes), each reading
printed as a multiple of its bound::

    python -m paddle_tpu_torch.tools.mesh_controls --axes '{"sp": 4}' \
        --backend gloo --out build/sp_controls -- --sp-modes \
        ring,ulysses,sequence_parallel --config llama3_8b --layers 2 \
        --seq 32768 --batch 1 --lr 1e-4 --device cuda:0

Prints one line a copy and, as the last line, a JSON object of every
copy's readings; exits 1 unless ``as_is`` passed and every fault was
refused.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from . import mesh_train

PKG = Path(__file__).resolve().parents[1]
BUILT = PKG.parent / "build" / "paddle_tpu_torch"

#: fault: (file in the package, the text, its replacement)
FAULTS = {
    # the gradients not averaged over the data ranks
    "no_data_mean": (
        "distributed/executor.py",
        "                collective.mean_rounded_once(p.grad, g)\n",
        "                pass\n"),
    # every fsdp rank keeps the first part of a gathered weight's gradient
    "fsdp_first_part": (
        "distributed/parallel_layers.py",
        "    return full.narrow(dim, group.rank * n, n).contiguous()",
        "    return full.narrow(dim, 0, n).contiguous()"),
    # a column-parallel input's gradient not summed over the tp ranks
    "no_tp_sum": (
        "distributed/parallel_layers.py",
        "        return collective.sum_rounded_once(g.clone(), ctx.group), "
        "None",
        "        return g, None"),
    # the expert stacks' gradients not averaged over the data ranks
    "no_expert_data_mean": (
        "distributed/executor.py",
        "            if p.grad is not None:\n",
        "            if p.grad is not None and \"expert\" not in getattr(\n"
        "                    p.placement, \"axes\", ()):\n"),
    # a combine that drops the rows of the experts on other ranks
    "combine_drops_remote": (
        "distributed/moe.py",
        "        if group.nranks > 1:\n"
        "            collective.all_reduce(out, group=group)\n",
        "        pass\n"),
    # the ring with the causal offset dropped: every held block masked
    # as if it were the diagonal
    "ring_no_offset": (
        "kernels/ring_attention.py",
        "        diag = causal and src == rank\n",
        "        diag = causal\n"),
    # labels not carried across the shard boundary: each rank's loss is
    # the dense model's on its part (shifted within it, its own count)
    "labels_not_carried": (
        "models/llama.py",
        "        labels_seq = self.model.shards(input_ids)\n",
        "        labels_seq = None\n"),
    # the gradients averaged over sp instead of summed
    "sp_grad_mean": (
        "distributed/executor.py",
        "                    collective.sum_divided_rounded_once(p.grad, "
        "*sp)\n",
        "                    collective.mean_rounded_once(p.grad, sp[0])\n"),
}
DENSE = ("no_data_mean", "fsdp_first_part", "no_tp_sum")
EXPERT = ("no_expert_data_mean", "combine_drops_remote")
SEQUENCE = ("ring_no_offset", "labels_not_carried", "sp_grad_mean")


def sp_margins(read):
    """Each mode's readings of phase 7q's comparison as multiples of
    their bounds: ``{mode: [loss / SP_LOSS_REL, grad / SP_GRAD_REL]}``
    and the largest of all."""
    out = {m: [r["loss"] / mesh_train.SP_LOSS_REL,
               r["grad"] / mesh_train.SP_GRAD_REL] for m, r in read.items()}
    return out, max(max(v) for v in out.values())


def planted_copy(fault, root: Path) -> Path:
    """``root`` holding the package with ``fault`` planted (``None``:
    as it is) and the built kernels linked in."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault is not None:
        rel, text, new = FAULTS[fault]
        path = root / "paddle_tpu_torch" / rel
        src = path.read_text()
        if src.count(text) != 1:
            raise RuntimeError(f"{fault}: {rel} holds its text "
                               f"{src.count(text)} times, not once")
        path.write_text(src.replace(text, new))
    (root / "build").mkdir()
    if BUILT.exists():
        (root / "build" / "paddle_tpu_torch").symlink_to(BUILT)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddle_tpu_torch.tools.mesh_controls")
    ap.add_argument("--axes", required=True, help="mesh axes as JSON")
    ap.add_argument("--backend", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=480.0,
                    help="a world's time limit (s)")
    ap.add_argument("--faults", default=None,
                    help="comma-separated names of FAULTS")
    ap.add_argument("train_args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    common = [x for x in a.train_args if x != "--"]
    moe = any(c in common for c in ("mixtral", "tiny_moe"))
    seq = "--sp-modes" in common
    faults = a.faults.split(",") if a.faults else \
        list(SEQUENCE if seq else EXPERT if moe else DENSE)
    n = 1
    for size in json.loads(a.axes).values():
        n *= size
    out = Path(a.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    ref = out / "ref.pt"
    train = [sys.executable, "-m", "paddle_tpu_torch.tools.mesh_train",
             *common]
    subprocess.run(train + ["--out", str(out / "single"),
                            "--save-grads" if seq else "--save-params",
                            str(ref)], cwd=PKG.parent, check=True)
    with open(out / "single" / "rank0.json") as f:
        single = json.load(f)
    results = {}
    for name in ["as_is", *faults]:
        root = planted_copy(None if name == "as_is" else name, out / name)
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc_per_node", str(n), "--timeout", str(a.timeout),
               "--log_dir", str(root / "log"), "-m",
               "paddle_tpu_torch.tools.mesh_train", *common, "--axes",
               a.axes, "--backend", a.backend, "--timeout", str(a.timeout),
               "--ref-grads" if seq else "--ref", str(ref), "--out",
               str(root / "res")]
        env = {**os.environ, "PYTHONPATH": str(root)}
        code = subprocess.run(cmd, cwd=root, env=env).returncode
        res = root / "res" / "rank0.json"
        if code != 0 or not res.exists():
            results[name] = {"ran": False, "exit": code}
            print(f"[control {name}] the world exited {code}: not run",
                  flush=True)
            continue
        with open(res) as f:
            r0 = json.load(f)
        if seq:
            read, fails = mesh_train.sp_against_single(r0, single)
            margins, top = sp_margins(read)
            results[name] = {"ran": True, "refused": bool(fails),
                             "margins": margins, "largest": top,
                             "fails": fails}
            shown = {m: [round(x, 3) for x in v] for m, v in margins.items()}
            print(f"[control {name}] {'refused' if fails else 'passed'}: "
                  f"readings / bounds (loss, gradient) {shown}; largest "
                  f"{top:.3g}", flush=True)
            continue
        read, fails = mesh_train.against_single(r0, single)
        results[name] = {"ran": True, "refused": bool(fails),
                         "loss": read["loss"], "worst": read["worst"],
                         "update": read["update"][read["worst"]],
                         "fails": fails}
        print(f"[control {name}] {'refused' if fails else 'passed'}: "
              f"loss {read['loss']:.3g} (limit {mesh_train.LOSS_REL:.3g}), "
              f"worst update {read['update'][read['worst']]:.3g} "
              f"({read['worst']}; limit {mesh_train.UPDATE_REL:.3g})",
              flush=True)
    print(json.dumps(results))
    ok = results["as_is"].get("refused") is False and all(
        results[f].get("refused") for f in faults)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
