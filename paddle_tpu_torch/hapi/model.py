"""hapi ``Model`` (the port of ``paddle_tpu/hapi/model.py``): ``prepare``,
``train_batch`` / ``eval_batch`` / ``predict_batch``, ``fit`` /
``evaluate`` / ``predict``, ``save`` / ``load``, ``parameters`` and
``summary`` over any ``torch.nn.Module``.

The JAX package compiles its train step with ``jit.to_static``; here it
runs eagerly (``jit.to_static`` is ROADMAP item A5's): the network's
forward, the loss, ``backward()``, ``optimizer.step()`` and
``clear_grad()``.  The network's kernels are its own (a Llama launches
the port's RMSNorm, RoPE and attention kernels).  Evaluation and
prediction run under ``torch.no_grad()``.  Batches (numpy arrays,
tensors, lists of either) go to the device of the network's parameters;
there is no fallback to another device.  ``amp_configs`` is taken and
ignored, as in the JAX package.  The options of later slices raise
``NotImplementedError`` (``LATER_SLICE_OPTIONS``).

``mesh`` (``prepare``, ``fit`` or ``use_mesh``: an ``{axis: size}``
dict, a ``distributed.Mesh`` or a ``distributed.MeshExecutor``) lays
the model out over a mesh of ranks, one process a rank
(``MeshExecutor.install``).  Every rank then calls the same methods
with the same GLOBAL batches: a step keeps this rank's rows of the
batch (``shard_batch``: dim 0 over ``data``), runs forward, loss and
backward on them, averages the gradients over ``data``
(``reduce_gradients``) and steps; the loss it returns, and evaluate's,
is the mean over the data ranks, the JAX package's global mean.  On a
tp > 1 mesh a Llama's logits are this rank's part of the vocabulary:
the loss must be vocab-parallel (``distributed.ParallelCrossEntropy``);
metrics and ``predict`` read the logits gathered whole.  A model that
splits its sequence over an ``sp`` axis (``context_parallel`` or
``sequence_parallel``) gets its inputs and labels cut along the
sequence too, the loss (a mean over the rank's tokens) taken as its
share of the global mean (``MeshExecutor.loss_share``), the gradients
summed over ``sp``; the loss returned is still the global mean.
``save`` /
``load`` gather the state to rank 0, which writes and reads the files,
and put it back into every rank's parts.

``fit`` keeps the JAX package's hooks: the callbacks (a
``ProgBarLogger``, an ``LRScheduler`` when the optimizer has a
scheduler, a ``ModelCheckpoint`` with ``save_dir``, then the caller's),
a :class:`~..observability.StepTimer` while the metrics registry is on,
and ``_skip_batch``, through which ``resilience.ResilienceCallback``
fast-forwards batches already in restored weights.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .. import observability
from ..framework.io import load as fload
from ..framework.io import save as fsave
from ..io import DataLoader, Dataset
from ..metric import Metric
from .callbacks import CallbackList, LRScheduler, ModelCheckpoint, \
    ProgBarLogger

# options of the JAX Model that belong to later slices: any value but
# the default raises, naming its ROADMAP item
LATER_SLICE_OPTIONS = {
    "xray": "A5's xray", "xray_on_start": "A5's xray",
    "hbm_budget_bytes": "A5's xray", "shardplan": "A5's shard-plan audit",
}


def _later(option):
    raise NotImplementedError(
        f"Model {option} belongs to ROADMAP item "
        f"{LATER_SLICE_OPTIONS[option]}; it is not ported to "
        "paddle_tpu_torch yet")


def _host(x):
    """A tensor as numpy (bf16 as its exact f32 values: numpy has no
    bf16)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._skip_batch = False
        self._mesh_executor = None

    # ------------------------------------------------------------ prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, mesh=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        if mesh is not None:
            self.use_mesh(mesh)

    def use_mesh(self, mesh):
        """Lay the network and the optimizer's slots out over ``mesh``
        (``distributed.MeshExecutor.install``); returns the executor."""
        from ..distributed.executor import as_executor

        return as_executor(mesh).install(self)

    def xray(self, *args, **kwargs):
        _later("xray")

    def shardplan(self, *args, **kwargs):
        _later("shardplan")

    # -------------------------------------------------------------- steps
    @staticmethod
    def _split_batch(data):
        if isinstance(data, (list, tuple)):
            if len(data) >= 2:
                return [data[0]], list(data[1:])
            return [data[0]], []
        return [data], []

    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _on_device(self, xs):
        """``xs`` (one value or a list; None for none) as a list of
        tensors on the network's device."""
        if xs is None:
            return []
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        dev = self._device()
        return [x.to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev) for x in xs]

    def _update_metrics(self, outputs, labels):
        if self._metrics and self._mesh_executor is not None:
            outputs = self._whole(outputs)
            labels = [self._whole_rows(y) for y in labels]
        for m in self._metrics:
            m.update(_host(m.compute(outputs, *labels)))

    def _batch(self, xs):
        """``xs`` on the network's device; under a mesh, this rank's
        rows of it."""
        if xs is None:
            return []
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        if self._mesh_executor is not None:
            xs = self._mesh_executor.shard_batch(
                [x if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in xs])
        return self._on_device(xs)

    def _whole_rows(self, t):
        """The data ranks' rows of ``t`` concatenated (every rank), each
        row whole along a split sequence first."""
        from ..distributed import collective
        from ..distributed.mesh import sequence_group

        if self._mesh_executor.sequence_sharded and t.dim() >= 2:
            sp = sequence_group(self._mesh_executor.mesh)
            t = torch.cat(collective.all_gather(None, t.contiguous(),
                                                group=sp), dim=1)
        g = self._mesh_executor.data_group()
        return torch.cat(collective.all_gather(None, t.contiguous(),
                                               group=g), dim=0)

    def _whole(self, outputs):
        """Outputs of the mesh's network whole: the vocabulary's parts
        concatenated when the network splits it (a Llama's
        ``_vocab_group``), then every data rank's rows."""
        from ..distributed.parallel_layers import mp_all_gather

        vocab = getattr(self.network, "_vocab_group", None)
        group = vocab() if callable(vocab) else None
        if group is not None:
            outputs = mp_all_gather(outputs, group)
        return self._whole_rows(outputs)

    def _share(self, losses):
        """Under a mesh, the loss as this rank's share of the global
        one (``MeshExecutor.loss_share``)."""
        if self._mesh_executor is None:
            return losses
        return self._mesh_executor.loss_share(losses)

    def _loss_value(self, losses) -> float:
        loss = float(losses.detach().float().mean())
        if self._mesh_executor is not None:
            loss = self._mesh_executor.mean_over_data(loss)
        return loss

    def train_batch(self, inputs, labels=None, update=True):
        """One step: forward, loss, backward (under a mesh, the
        gradients averaged over the data ranks), ``optimizer.step()`` and
        ``clear_grad()``; the metrics updated.  Returns the loss as a
        float, which waits for the device."""
        self.network.train()
        inputs, labels = self._batch(inputs), self._batch(labels)
        outputs = self.network(*inputs)
        losses = self._share(self._loss(outputs, *labels))
        losses.backward()
        if self._mesh_executor is not None:
            self._mesh_executor.reduce_gradients(self.network)
        self._optimizer.step()
        self._optimizer.clear_grad()
        loss = self._loss_value(losses)
        with torch.no_grad():
            self._update_metrics(outputs.detach(), labels)
        return loss

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._batch(inputs), self._batch(labels)
        outputs = self.network(*inputs)
        losses = self._share(self._loss(outputs, *labels))
        self._update_metrics(outputs, labels)
        return self._loss_value(losses)

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        out = self.network(*self._batch(inputs))
        return out if self._mesh_executor is None else self._whole(out)

    # -------------------------------------------------------------- loops
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None,
            xray_on_start=False, hbm_budget_bytes=None, shardplan=None,
            mesh=None):
        """Train ``epochs`` epochs over ``train_data`` (a ``Dataset``,
        batched by a ``DataLoader``, or any iterable of batches; a batch
        is ``(inputs, *labels)``); returns ``{"loss": [last loss of each
        epoch]}``.  ``accumulate_grad_batches`` is taken and ignored, as
        in the JAX package."""
        for option, value in (("xray_on_start", xray_on_start),
                              ("hbm_budget_bytes", hbm_budget_bytes),
                              ("shardplan", shardplan)):
            if value not in (None, False):
                _later(option)
        if mesh is not None and self._mesh_executor is None:
            self.use_mesh(mesh)
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        cbs = [ProgBarLogger(log_freq, verbose=verbose)]
        if self._optimizer is not None and \
                self._optimizer._lr_scheduler is not None:
            cbs.append(LRScheduler())
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        cbs += list(callbacks or [])
        cb_list = CallbackList(cbs)
        cb_list.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cb_list.set_params({"epochs": epochs, "steps": steps,
                            "verbose": verbose})

        self.stop_training = False
        cb_list.on_train_begin()
        history = {"loss": []}
        # step telemetry only while a sink armed the registry
        timer = observability.StepTimer() if observability.enabled() \
            else None
        for epoch in range(epochs):
            cb_list.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            epoch_logs = {}
            batches = enumerate(train_loader) if timer is None \
                else timer.timed_enumerate(train_loader)
            for step, batch in batches:
                if num_iters is not None and step >= num_iters:
                    break
                cb_list.on_train_batch_begin(step)
                if self._skip_batch:
                    # a resume-capable callback (resilience.
                    # ResilienceCallback) fast-forwards batches already
                    # baked into restored weights: consume from the
                    # stream, don't execute
                    self._skip_batch = False
                    continue
                inputs, labels = self._split_batch(batch)
                loss = self.train_batch(inputs, labels)
                if timer is not None:
                    timer.step(loss=loss, inputs=inputs)
                logs = {"loss": loss}
                for m in self._metrics:
                    names, vals = m.name(), m.accumulate()
                    if isinstance(names, list):
                        logs.update(dict(zip(names, vals)))
                    else:
                        logs[names] = vals
                epoch_logs = logs
                cb_list.on_train_batch_end(step, logs)
                if self.stop_training:
                    break
            history["loss"].append(epoch_logs.get("loss"))
            cb_list.on_epoch_end(epoch, epoch_logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=verbose,
                              _callbacks=cb_list)
            if self.stop_training:
                break
        cb_list.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None,
                 _callbacks=None):
        """The mean loss over ``eval_data`` and each metric's
        accumulation, as a dict."""
        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = eval_data
        cb_list = _callbacks or CallbackList(list(callbacks or []))
        if _callbacks is None:
            cb_list.set_model(self)
        for m in self._metrics:
            m.reset()
        cb_list.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            inputs, labels = self._split_batch(batch)
            losses.append(self.eval_batch(inputs, labels))
        logs = {"loss": float(np.mean(losses)) if losses else None}
        for m in self._metrics:
            names, vals = m.name(), m.accumulate()
            if isinstance(names, list):
                logs.update(dict(zip(names, vals)))
            else:
                logs[names] = vals
        cb_list.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """``[outputs]``: each batch's outputs as numpy (bf16 as f32), or
        with ``stack_outputs`` one concatenated array."""
        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            out = self.predict_batch(inputs)
            outputs.append(_host(out) if isinstance(out, torch.Tensor)
                           else [_host(o) for o in out])
        if stack_outputs and outputs and isinstance(outputs[0], np.ndarray):
            return [np.concatenate(outputs)]
        return [outputs]

    # ------------------------------------------------------------ persist
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's), through
        ``framework.io.save``; in a world of more than one rank written
        by rank 0 (every rank calls it), under a mesh gathered whole
        first."""
        from ..distributed import collective, get_rank, get_world_size

        ex = self._mesh_executor
        params = self.network.state_dict() if ex is None \
            else ex.gathered_state(self.network.state_dict(keep_vars=True))
        opt = self._optimizer.state_dict() \
            if training and self._optimizer is not None else None
        if get_rank() == 0:
            fsave(params, path + ".pdparams")
            if opt is not None:
                fsave(opt, path + ".pdopt")
        if get_world_size() > 1:
            collective.barrier()

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """The state :meth:`save` wrote; under a mesh read by rank 0 and
        put into every rank's parts (every rank calls it)."""
        from ..convert import load_named
        from ..distributed import get_rank

        opt_path = path + ".pdopt"
        with_opt = not reset_optimizer and self._optimizer is not None
        ex = self._mesh_executor
        state = None
        if ex is None or get_rank() == 0:
            state = {"model": fload(path + ".pdparams")}
            if with_opt and os.path.exists(opt_path):
                state["optimizer"] = fload(opt_path)
        if ex is None:
            self.network.load_state_dict(state["model"])
            if "optimizer" in state:
                self._optimizer.set_state_dict(state["optimizer"])
            return
        state = ex.scatter_from_rank0(state, self.network,
                                      self._optimizer if with_opt else None)
        load_named(self.network, state["model"])
        if "optimizer" in state:
            self._optimizer.set_state_dict(state["optimizer"])

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net, input_size=None, dtype=None):
    """``paddle.summary``: print the parameter table; returns the total
    and trainable parameter counts."""
    rows = []
    total = trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, list(p.shape), n))
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'Param':<{width}}{'Shape':<20}{'Count':>12}"]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
