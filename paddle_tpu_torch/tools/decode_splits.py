"""Time the paged decode at several split counts, L2-cold, on one card:

    python -m paddle_tpu_torch.tools.decode_splits

For the attention shapes of ``chip_smoke.py``'s phases 2 and 2c
(Phi-3-mini's, Gemma-7B's and Phi-2's heads on the padded instances,
Llama-3-8B's and Qwen2-7B's on the instances of 128 columns) over bf16
and int8 pools, it prints the split count ``decode_plan`` gives and the
kernel's time at that count and at 1 to 16 splits, each output held to
the plain version within ``chip_smoke.bf16_tol``.  The splits change
only how a sequence's keys are shared among blocks (the order of the f32
sums), so every count computes the same function.  Prints the card's
name and power limit first.
"""
from __future__ import annotations

import sys

import torch

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
LLAMA = ("llama3_8b", 32, 8, 128, 16, 8192, 5e5)


def main() -> int:
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import kv_quant
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cs.phase_build()
    g = torch.Generator(device=dev).manual_seed(4)
    plan = pa.decode_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        for shape in (cs.C1_PHI3, cs.C1_GEMMA, cs.C1_PHI2, LLAMA,
                      cs.C1_QWEN2):
            ops = cs._attn_operands(g, dev, shape)
            H, KVH, bs = shape[1], shape[2], shape[4]
            for scheme in (None, "int8"):
                if scheme is None:
                    kp, vp, ks, vs = ops["k"], ops["v"], None, None
                else:
                    (kp, ks), (vp, vs) = (kv_quant.quantize_kv(ops[x], scheme)
                                          for x in "kv")
                args = (ops["q"], ops["c"], ops["s"], kp, vp, ops["bt"],
                        ops["pos"], 1, ks, vs, scheme)
                nbytes = sum(t.numel() * t.element_size()
                             for t in (kp, vp, ops["bt"], ks, vs)
                             if t is not None)
                cold = [(*args[:3], kp.clone(), vp.clone(), ops["bt"].clone(),
                         ops["pos"], 1, None if ks is None else ks.clone(),
                         None if vs is None else vs.clone(), scheme)
                        for _ in range(cs.cold_copies(nbytes))]
                ref = pa.paged_decode_attention_plain(*args)
                want = plan(8, KVH, ops["nbs"], bs, sms,
                            pa.hopper_group(H // KVH)[1],
                            pa.blocks_per_sm(ops["q"], scheme))
                row = []
                for S in (None, *SPLITS):
                    pa.decode_plan = plan if S is None else \
                        (lambda *a, S=S: S)
                    out = pa.paged_decode_attention(*args)
                    err = float((out.float() - ref.float()).abs().max())
                    if err > cs.bf16_tol(ref):
                        raise AssertionError(f"{shape[0]} S={S}: {err}")
                    ms = cs.time_ms_rotating([
                        lambda a=a: pa.paged_decode_attention(*a)
                        for a in cold])
                    row.append(f"{'plan' if S is None else S}: {ms:.4f}")
                print(f"{shape[0]} {H}/{KVH} heads D={shape[3]} "
                      f"{scheme or 'bf16'} pools (plan {want} splits), ms "
                      f"by splits: {', '.join(row)}", flush=True)
                del cold
    finally:
        pa.decode_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
