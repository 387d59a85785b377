"""One rank of the card's mesh checks, its results pickled to
``OUT/rank<r>.pkl``; imports torch and the port only.

- ``test_torch_cuda.py::TestCudaMeshTP`` (no MODE): the tiny f32 Llama
  (seed 0) laid out on a ``{"tp": 2}`` mesh on cuda:0 over gloo, one
  forward and backward of the vocab-parallel loss, the gradients
  gathered whole, then a ring of CUDA tensors through send/recv (which
  the port stages through host memory under gloo).
- ``TestCudaExpertParallel`` (MODE ``ep``): the tiny f32 MoE Llama
  (seed 0, 4 experts) on ``{"expert": 2}``, one forward and backward,
  the gradients gathered whole, and ``global_scatter`` of a CUDA tensor
  (staged through host memory).
- ``TestCudaSequenceParallel`` (MODE ``sp``): the tiny f32 Llama (seed
  0) with each of ``SP_MODES`` on ``{"sp": 2}``, each rank its half of
  the sequence, the model's shifted loss (its share of the global one),
  one backward, the gradients summed over sp by
  ``MeshExecutor.reduce_gradients``; the launches, collectives and
  staged ones of each.
- ``TestCudaTensorParallel`` (MODE ``tp``): on ``{"tp": 2}``, the tied
  tiny f32 Llama (seed 0) with the fused chunked loss over the split
  vocabulary, then the tiny f32 MoE Llama (seed 0, 4 experts) with its
  expert stacks split over tp: each one forward and backward, the
  gradients gathered whole, the launches and collectives of each.
- ``TestCudaPipeline`` (MODE ``pp``): the tiny f32 ``LlamaForCausalLMPipe``
  (seed 0) on ``{"pp": 2}``, one stage a rank, the schedule of
  ``PP_MICRO`` microbatches (1F1B, then GPipe): the loss, this stage's
  gradients, the launches and the hops (staged through host memory).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        tests/torch_mesh_cuda_rank.py OUT [ep|sp|pp|tp]
"""
import os
import pickle
import sys

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.sharding import gather_full
from paddle_tpu_torch.kernels import launches
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

SEQ = 32


def tokens(device):
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, SEQ))).to(device)


MOE = dict(moe_num_experts=4, moe_capacity_factor=1.0)
SP_MODES = {"ring": dict(context_parallel="ring"),
            "ulysses": dict(context_parallel="ulysses"),
            "sequence_parallel": dict(sequence_parallel=True)}


def sequence_modes(dev):
    """Each of SP_MODES on {"sp": 2}: the global loss, every gradient
    (whole: the parameters are replicated), launches and collectives."""
    out = {}
    for name, opts in SP_MODES.items():
        net = LlamaForCausalLM(LlamaConfig.tiny(max_position_embeddings=SEQ,
                                                **opts),
                               device=dev, seed=0)
        ex = dist.MeshExecutor({"sp": 2})
        ex.install(net)
        ids, = ex.shard_batch([tokens(dev)])
        launches.reset()
        dist.collective.reset_counts()
        loss, _ = net(ids, labels=ids)
        loss.backward()
        ex.reduce_gradients(net)
        torch.cuda.synchronize()
        out[name] = dict(
            loss=ex.mean_over_data(float(loss.detach())),
            part=tuple(ids.shape), launches=launches.snapshot(),
            counts=dist.collective.counts(),
            staged=dist.collective.staged_counts(),
            grads={n: p.grad.cpu().numpy()
                   for n, p in net.named_parameters()})
        ex.close()
    return out


TP_MODELS = {"tied_fused": dict(tie_word_embeddings=True, fused_lm_loss=True,
                                lm_loss_chunk=16),
             "moe": MOE}


def tensor_parallel(dev):
    """Each of TP_MODELS on {"tp": 2}: the loss, every gradient gathered
    whole, the launches and the collectives."""
    out = {}
    for name, opts in TP_MODELS.items():
        net = LlamaForCausalLM(LlamaConfig.tiny(max_position_embeddings=SEQ,
                                                **opts),
                               device=dev, seed=0)
        ex = dist.MeshExecutor({"tp": 2})
        ex.install(net)
        ids = tokens(dev)
        launches.reset()
        dist.collective.reset_counts()
        loss, _ = net(ids, labels=ids)
        loss.backward()
        torch.cuda.synchronize()
        grads = {}
        for n, p in net.named_parameters():
            g = p.grad
            if getattr(p, "placement", None) is not None:
                g.placement = p.placement
            grads[n] = gather_full(g).cpu().numpy()
        out[name] = dict(loss=float(loss.detach()),
                         launches=launches.snapshot(),
                         counts=dist.collective.counts(), grads=grads)
        ex.close()
    return out


PP_MICRO = 2


def pipeline_stage(dev):
    """This rank's stage of the tiny pipe on {"pp": 2} under each
    schedule."""
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.models.llama_pp import LlamaForCausalLMPipe

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 2}
    s.pipeline_configs = {"accumulate_steps": PP_MICRO}
    fleet.init(is_collective=True, strategy=s)
    pipe = LlamaForCausalLMPipe(LlamaConfig.tiny(max_position_embeddings=SEQ),
                                device=dev, seed=0)
    model = fleet.distributed_model(pipe)
    ids = tokens(dev)
    out = {}
    for mode in ("1F1B", "FThenB"):
        model.schedule_mode = mode
        launches.reset()
        collective.reset_counts()
        loss = model.forward_backward_pipeline((ids, ids))
        torch.cuda.synchronize()
        out[mode] = dict(
            loss=float(loss), stage=pipe.stage_id,
            launches=launches.snapshot(), counts=collective.counts(),
            staged=collective.staged_counts(),
            in_flight=model.last_stats.max_in_flight,
            grads={n: p.grad.cpu().numpy()
                   for n, p in pipe.named_parameters()})
        for p in pipe.parameters():
            p.grad = None
    return out


def main(out, mode=None):
    dist.init_parallel_env(backend="gloo", device="cuda:0", timeout=120)
    dev = dist.current_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode in ("sp", "pp", "tp"):
        res = {"sp": sequence_modes, "pp": pipeline_stage,
               "tp": tensor_parallel}[mode](dev)
        with open(os.path.join(out, f"rank{dist.get_rank()}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
        dist.destroy_parallel_env()
        return
    ep = mode == "ep"
    net = LlamaForCausalLM(LlamaConfig.tiny(max_position_embeddings=SEQ,
                                            **(MOE if ep else {})),
                           device=dev, seed=0)
    dist.MeshExecutor({"expert": 2} if ep else {"tp": 2}).install(net)
    ids = tokens(dev)
    launches.reset()
    dist.collective.reset_counts()
    loss, _ = net(ids, labels=ids)
    loss.backward()
    torch.cuda.synchronize()
    res = dict(loss=float(loss.detach()), launches=launches.snapshot(),
               heads=net.model.layers[0].self_attn.q_proj.weight.shape,
               experts=tuple(net.model.layers[0].mlp.w_gate.shape)
               if ep else None)
    res["grads"] = {}
    for name, p in net.named_parameters():
        g = p.grad
        if getattr(p, "placement", None) is not None:
            g.placement = p.placement
        res["grads"][name] = gather_full(g).cpu().numpy()
    rank = dist.get_rank()
    if ep:
        from paddle_tpu_torch.distributed.utils import global_scatter

        x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
        dist.collective.reset_counts()
        res.update(routed=global_scatter(x.reshape(4, 2)).cpu().numpy(),
                   staged=dist.collective.staged_counts())
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
        dist.destroy_parallel_env()
        return
    x = torch.full((4,), float(rank + 1), device=dev)
    buf = torch.empty(4, device=dev)
    if rank == 0:
        dist.send(x, 1)
        dist.recv(buf, 1)
    else:
        dist.recv(buf, 0)
        dist.send(x, 0)
    res.update(ring=buf.cpu().numpy(), counts=dist.collective.counts(),
               staged=dist.collective.staged_counts())
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_parallel_env()


if __name__ == "__main__":
    main(*sys.argv[1:])
