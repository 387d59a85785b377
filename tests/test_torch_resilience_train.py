"""The port's training resilience (``paddle_tpu_torch.resilience``:
``FaultPlan``'s training sites, ``ResilientCheckpointer``, ``Sentry``,
``ResilienceCallback``) against the JAX package's.

The cases of ``tests/test_resilience.py``'s ``TestFaultPlan``,
``TestResilientCheckpointer``, ``TestSentry``, ``TestKillResume`` and
``TestSentryInFit``, on the port: a small MLP (Adam, ``MSELoss``) over
a fixed list of batches, killed, corrupted or poisoned, and resumed to
final weights bit-identical to an uninterrupted run on the CPU.  Then
against the reference: one ``FaultPlan`` gives the same ``injected``
log and callback ``events`` in both packages; a JAX tiny-Llama fit
killed at step k leaves a checkpoint directory the port's callback
resumes from, to the JAX uninterrupted run's weights within
WEIGHT_TOL (the port's and the reference's steps agree to f32 sums in
another order; see ``test_torch_hapi.py``).  ``Sentry`` backs off with
a base of 0 here: no test sleeps.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.resilience import FaultPlan as JFaultPlan
from paddle_tpu.resilience import ResilienceCallback as JResilienceCallback
from paddle_tpu.resilience import SimulatedPreemption as JPreemption
from paddle_tpu.resilience import chaos as jchaos
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.resilience import (OK, REWIND, SKIP, ChaosError,
                                         FaultPlan, ResilienceCallback,
                                         ResilientCheckpointer, Sentry,
                                         SimulatedPreemption, chaos,
                                         collect_state, host_snapshot)
from paddle_tpu_torch.resilience.checkpoint import CheckpointCorruption

WEIGHT_TOL = 1e-5


# ---------------------------------------------------------------------------
# the tiny-regression harness of the reference's tests
# ---------------------------------------------------------------------------

def _make_model(seed=0, lr=0.01):
    gen = torch.Generator().manual_seed(seed)
    net = torch.nn.Sequential(
        tnn.Linear(4, 16, device="cpu", init=gen, init_std=0.5),
        torch.nn.ReLU(),
        tnn.Linear(16, 2, device="cpu", init=gen, init_std=0.25))
    model = pt.Model(net)
    model.prepare(Adam(lr, parameters=net.parameters()), tnn.MSELoss())
    return model


def _batches(n=10, bs=8, seed=1):
    """A fixed LIST of (x, y) batches — the same data at the same step
    every run, the precondition for bit-identical resume."""
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 2).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.randn(bs, 4).astype(np.float32)
        out.append((x, (x @ w).astype(np.float32)))
    return out


def _weights(model):
    return {k: v.detach().clone() for k, v in
            model.network.state_dict().items()}


def _train_uninterrupted(batches, **model_kw):
    model = _make_model(**model_kw)
    model.fit(train_data=batches, epochs=1, verbose=0)
    return _weights(model)


def _state(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return {"model": {"w": rng.randn(64, 8).astype(np.float32)},
            "optimizer": {"m": rng.randn(n).astype(np.float32)}}


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

class TestFaultPlan:
    def test_hooks_noop_when_inactive(self):
        assert chaos.active_plan() is None
        chaos.on_step(0)
        chaos.on_save("x")
        chaos.after_save("x")
        chaos.maybe_fail_request("r")
        arrays = [np.ones(4, np.float32)]
        assert chaos.poison_batch(0, arrays) is arrays

    def test_no_nesting(self):
        with FaultPlan():
            with pytest.raises(RuntimeError, match="nest"):
                with FaultPlan():
                    pass
        assert chaos.active_plan() is None

    def test_exit_clears_on_exception(self):
        with pytest.raises(ChaosError):
            with FaultPlan(kill_at_step=0):
                chaos.on_step(0)
        assert chaos.active_plan() is None

    def test_poison_batch_deterministic_and_the_references(self):
        x = np.arange(32, dtype=np.float32).reshape(4, 8)
        y = np.arange(4, dtype=np.int64)  # ints are never poisoned
        with FaultPlan(seed=7, nan_batch_steps=[2]) as plan:
            a1, b1 = chaos.poison_batch(2, [x, y])
            clean_x, clean_y = chaos.poison_batch(3, [x, y])
        with FaultPlan(seed=7, nan_batch_steps=[2]):
            a2, _ = chaos.poison_batch(2, [x, y])
        with JFaultPlan(seed=7, nan_batch_steps=[2]) as jplan:
            ja, _ = jchaos.poison_batch(2, [x, y])
        assert np.isnan(a1).any() and not np.isnan(x).any()
        np.testing.assert_array_equal(a1, a2)  # seeded == reproducible
        np.testing.assert_array_equal(a1, ja)  # the reference's positions
        np.testing.assert_array_equal(b1, y)
        np.testing.assert_array_equal(clean_x, x)
        assert plan.injected == jplan.injected == [("poison", 2)]

    def test_inf_poisoning(self):
        x = np.zeros(16, np.float32)
        with FaultPlan(inf_batch_steps=[0]):
            (out,) = chaos.poison_batch(0, [x])
        assert np.isinf(out).any() and not np.isnan(out).any()

    def test_corruption_utilities_are_the_references(self, tmp_path):
        paths = []
        for util in (chaos, jchaos):
            p = str(tmp_path / f"{util.__name__}.bin")
            with open(p, "wb") as f:
                f.write(b"\x00" * 100)
            util.truncate_file(p, keep_frac=0.5)
            assert os.path.getsize(p) == 50
            util.bitflip_file(p, nbits=4, seed=3)
            paths.append(p)
        a, b = (open(p, "rb").read() for p in paths)
        assert a == b != b"\x00" * 50

    def test_step_faults(self):
        with FaultPlan(delay_steps={1: 1e-3}, kill_at_step=2) as plan:
            chaos.on_step(0)
            chaos.on_step(1)
            with pytest.raises(SimulatedPreemption, match="step 2"):
                chaos.on_step(2)
        assert plan.injected == [("delay", 1), ("kill", 2)]

    @pytest.mark.parametrize("arg,value", [
        ("kill_process_at", {3: 0}), ("kill_save_site", "resilience::"),
        ("save_fault_process", 1), ("kill_save_site_ordinal", 2)])
    def test_faults_of_other_processes_wait_for_a3(self, arg, value):
        with pytest.raises(NotImplementedError, match="A3"):
            FaultPlan(**{arg: value})
        with pytest.raises(TypeError, match="unexpected"):
            FaultPlan(kill_everything=True)
        FaultPlan(kill_hard=True)          # taken: it shapes those only


# ---------------------------------------------------------------------------
# ResilientCheckpointer
# ---------------------------------------------------------------------------

class TestResilientCheckpointer:
    def test_roundtrip_and_manifest(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path))
        state = _state()
        d = ck.save(3, state)
        manifest = json.load(open(os.path.join(d, "manifest.json")))
        assert manifest["step"] == 3 and manifest["format"] == 1
        assert sorted(manifest["files"]) == ["model.pkl", "optimizer.pkl"]
        step, restored = ck.restore_latest()
        assert step == 3
        np.testing.assert_array_equal(restored["model"]["w"],
                                      state["model"]["w"])
        assert not [n for n in os.listdir(str(tmp_path))
                    if n.startswith(".tmp-")]

    def test_truncated_latest_falls_back(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path))
        ck.save(1, _state(seed=1))
        ck.save(2, _state(seed=2))
        chaos.truncate_file(os.path.join(ck._step_dir(2), "model.pkl"))
        step, restored = ck.restore_latest()
        assert step == 1 and ck.corrupt_skipped == 1
        np.testing.assert_array_equal(restored["model"]["w"],
                                      _state(seed=1)["model"]["w"])

    def test_bitflip_detected(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path))
        ck.save(1, _state())
        chaos.bitflip_file(os.path.join(ck._step_dir(1), "model.pkl"))
        with pytest.raises(CheckpointCorruption, match="sha256"):
            ck.restore(1)
        assert ck.restore_latest() == (None, None)

    def test_crash_mid_save_leaves_previous_intact(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path))
        ck.save(1, _state(seed=1))
        with FaultPlan(crash_on_save=2):
            with pytest.raises(ChaosError, match="injected crash"):
                ck.save(2, _state(seed=2))
        assert ck.steps() == [1]           # no torn step_2 directory
        assert not [n for n in os.listdir(str(tmp_path))
                    if n.startswith(".tmp-")]
        step, _ = ck.restore_latest()
        assert step == 1 and ck.corrupt_skipped == 0

    def test_gc_keeps_max_to_keep(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path), max_to_keep=2)
        for s in range(5):
            ck.save(s, _state(seed=s))
        assert ck.steps() == [3, 4]

    def test_async_save_commits_and_backpressure_bound(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path), max_to_keep=10,
                                   max_pending=2)
        for s in range(6):
            ck.save_async(s, _state(seed=s))
            assert ck.stats()["pending_async"] <= 2
        ck.wait()
        assert ck.steps() == list(range(6))
        step, restored = ck.restore_latest()
        assert step == 5
        np.testing.assert_array_equal(restored["model"]["w"],
                                      _state(seed=5)["model"]["w"])
        ck.close()

    def test_async_error_surfaces_on_wait(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path))
        with FaultPlan(crash_on_save=1):
            ck.save_async(1, _state())
            with pytest.raises(ChaosError, match="injected crash"):
                ck.wait()
        ck.close()
        assert ck.steps() == []

    def test_preemption_flag_latches(self, tmp_path):
        ck = ResilientCheckpointer(str(tmp_path))
        ck.install_preemption_handler()
        try:
            assert not ck.preemption_requested
            os.kill(os.getpid(), signal.SIGTERM)
            assert ck.preemption_requested
        finally:
            ck.uninstall_preemption_handler()

    def test_stale_tmp_reaped_on_init(self, tmp_path):
        os.makedirs(str(tmp_path / ".tmp-9-1-dead"))
        os.makedirs(str(tmp_path / ".tmp-p0-77-1-dead"))
        live = tmp_path / ".tmp-p3-5-1-live"
        os.makedirs(str(live))
        ck = ResilientCheckpointer(str(tmp_path))
        assert [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp-")] == [live.name]
        assert ck.steps() == []
        ResilientCheckpointer(str(tmp_path), reap_age_s=-1.0)
        assert not live.exists()              # older than the age limit

    def test_sharded_layout_waits_for_a3(self, tmp_path):
        with pytest.raises(NotImplementedError, match="A3"):
            ResilientCheckpointer(str(tmp_path), sharded=True)
        d = tmp_path / "step_00000001"
        os.makedirs(str(d))
        (d / "manifest.json").write_text(json.dumps({"format": 2}))
        with pytest.raises(NotImplementedError, match="A3"):
            ResilientCheckpointer(str(tmp_path)).restore(1)

    def test_bf16_state_round_trips(self, tmp_path):
        t = torch.randn(5, 3).bfloat16()
        ck = ResilientCheckpointer(str(tmp_path))
        ck.save(1, {"model": {"w": t}, "meta": {"step": 1}})
        _, restored = ck.restore_latest()
        got = pt.framework.io.to_tensor(restored["model"]["w"])
        assert got.dtype == torch.bfloat16 and torch.equal(got, t)
        assert restored["meta"] == {"step": 1}


class TestSnapshotIsAFinishedHostCopy:
    """``optimizer.step()`` writes parameters and moments in place, so a
    snapshot must not alias them: mutated right after ``save_async``,
    the checkpoint still holds the state at the call."""

    def test_mutation_after_save_async(self, tmp_path):
        model = _make_model()
        model.fit(_batches(3), verbose=0)
        before = collect_state(model.network, model._optimizer)
        ck = ResilientCheckpointer(str(tmp_path))
        ck.save_async(3, collect_state(model.network, model._optimizer))
        with torch.no_grad():
            for p in model.network.parameters():
                p.add_(1.0)
            for store in model._optimizer._accumulators.values():
                for acc in store.values():
                    acc.mul_(-3.0)
        ck.wait()
        ck.close()
        _, restored = ck.restore_latest()
        for key in ("model", "optimizer"):
            for k, v in before[key].items():
                np.testing.assert_array_equal(restored[key][k], v,
                                              err_msg=k)
        live = dict(model.network.state_dict())
        assert not np.array_equal(restored["model"]["0.weight"],
                                  live["0.weight"].numpy())

    def test_host_snapshot_copies_every_leaf(self):
        t = torch.ones(3)
        a = np.zeros(2)
        snap = host_snapshot({"t": t, "l": [a, 1], "s": "x"})
        t.add_(1)
        a += 1
        assert snap["t"].tolist() == [1, 1, 1]
        assert snap["l"][0].tolist() == [0, 0] and snap["l"][1] == 1


# ---------------------------------------------------------------------------
# Sentry
# ---------------------------------------------------------------------------

class TestSentry:
    def test_classification(self):
        s = Sentry(max_consecutive_bad=3)
        assert s.observe(1.0) == OK
        assert s.observe(float("nan")) == SKIP
        assert s.observe(float("inf")) == SKIP
        assert s.observe(float("nan")) == REWIND   # 3rd consecutive
        assert s.consecutive_bad == 0              # reset after rewind
        assert s.observe(0.5) == OK
        assert (s.skips, s.rewinds, s.bad_steps) == (2, 1, 3)

    def test_good_step_resets_streak(self):
        s = Sentry(max_consecutive_bad=2)
        assert s.observe(float("nan")) == SKIP
        assert s.observe(1.0) == OK
        assert s.observe(float("nan")) == SKIP     # streak restarted

    def test_grad_norm_checked_too(self):
        s = Sentry()
        assert s.observe(1.0, grad_norm=float("inf")) == SKIP

    def test_tensor_and_array_inputs(self):
        s = Sentry()
        assert s.observe(torch.tensor(2.0)) == OK
        assert s.observe(np.array([1.0, np.nan])) == SKIP
        assert s.observe(torch.tensor([1.0, float("inf")])) == SKIP

    def test_backoff_grows_exponentially(self, monkeypatch):
        import paddle_tpu_torch.resilience.sentry as sentry_mod

        slept = []
        monkeypatch.setattr(sentry_mod.time, "sleep", slept.append)
        s = Sentry(max_consecutive_bad=10, backoff_base_s=1e-4,
                   backoff_factor=2.0)
        s.observe(float("nan"))
        first = s.last_backoff_s
        s.observe(float("nan"))
        assert s.last_backoff_s == pytest.approx(first * 2.0)
        assert slept == [1e-4, 2e-4]
        with pytest.raises(ValueError):
            Sentry(max_consecutive_bad=0)


# ---------------------------------------------------------------------------
# kill at step N -> bit-identical resume
# ---------------------------------------------------------------------------

class TestKillResume:
    def _killed_then_resumed(self, tmp_path, batches, kill_at,
                             async_save=False):
        ckdir = str(tmp_path / "ck")
        model = _make_model()
        cb = ResilienceCallback(ckdir, save_every=1, async_save=async_save)
        with pytest.raises(SimulatedPreemption):
            with FaultPlan(kill_at_step=kill_at):
                model.fit(train_data=batches, epochs=1, verbose=0,
                          callbacks=[cb])
        # a fresh process: new model object, same deterministic data
        model2 = _make_model()
        cb2 = ResilienceCallback(ckdir, save_every=1)
        model2.fit(train_data=batches, epochs=1, verbose=0, callbacks=[cb2])
        return model2, cb2

    def test_bit_identical_resume(self, tmp_path):
        batches = _batches(n=10)
        reference = _train_uninterrupted(batches)
        model2, cb2 = self._killed_then_resumed(tmp_path, batches,
                                                kill_at=6)
        assert ("resume", 6) in cb2.events        # steps 0..5 completed
        assert cb2.checkpointer.corrupt_skipped == 0
        _same(_weights(model2), reference)

    def test_bit_identical_resume_async_saves(self, tmp_path):
        batches = _batches(n=8)
        reference = _train_uninterrupted(batches)
        model2, cb2 = self._killed_then_resumed(tmp_path, batches,
                                                kill_at=5, async_save=True)
        assert ("resume", 5) in cb2.events
        _same(_weights(model2), reference)

    def test_resume_after_truncated_latest(self, tmp_path):
        batches = _batches(n=10)
        reference = _train_uninterrupted(batches)
        ckdir = str(tmp_path / "ck")
        model = _make_model()
        cb = ResilienceCallback(ckdir, save_every=1, max_to_keep=3)
        with pytest.raises(SimulatedPreemption):
            with FaultPlan(kill_at_step=6):
                model.fit(train_data=batches, epochs=1, verbose=0,
                          callbacks=[cb])
        chaos.truncate_file(os.path.join(cb.checkpointer._step_dir(6),
                                         "model.pkl"))
        model2 = _make_model()
        cb2 = ResilienceCallback(ckdir, save_every=1)
        model2.fit(train_data=batches, epochs=1, verbose=0,
                   callbacks=[cb2])
        assert ("resume", 5) in cb2.events        # fell back one step
        assert cb2.checkpointer.corrupt_skipped == 1
        _same(_weights(model2), reference)

    def test_sigterm_saves_and_stops_then_resumes(self, tmp_path):
        batches = _batches(n=10)
        reference = _train_uninterrupted(batches)
        ckdir = str(tmp_path / "ck")
        model = _make_model()
        # save_every high: the preemption save is the ONLY checkpoint
        cb = ResilienceCallback(ckdir, save_every=100)
        with FaultPlan(sigterm_at_step=4):
            model.fit(train_data=batches, epochs=1, verbose=0,
                      callbacks=[cb])
        assert model.stop_training
        assert ("preempt-save", 5) in cb.events   # steps 0..4 done
        model2 = _make_model()
        cb2 = ResilienceCallback(ckdir, save_every=100)
        model2.fit(train_data=batches, epochs=1, verbose=0,
                   callbacks=[cb2])
        assert ("resume", 5) in cb2.events
        _same(_weights(model2), reference)

    def test_tiny_llama_resumes_bit_identical(self, tmp_path):
        """The port's Llama (its plain kernels here) through fit, killed
        at step 3 of 6 and resumed."""
        def make():
            net = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
            m = pt.Model(net)
            m.prepare(pt.optimizer.AdamW(1e-3, parameters=net.parameters()),
                      tnn.CrossEntropyLoss(), pt.metric.Accuracy())
            return m
        data = _token_batches(6)
        ref = make()
        ref.fit(data, verbose=0)
        killed = make()
        with pytest.raises(SimulatedPreemption):
            with FaultPlan(kill_at_step=3):
                killed.fit(data, verbose=0, callbacks=[ResilienceCallback(
                    str(tmp_path), save_every=1)])
        resumed = make()
        cb = ResilienceCallback(str(tmp_path), save_every=1)
        resumed.fit(data, verbose=0, callbacks=[cb])
        assert ("resume", 3) in cb.events
        _same(_weights(resumed), _weights(ref))


# ---------------------------------------------------------------------------
# NaN-batch skip + rewind (the sentry wired into fit)
# ---------------------------------------------------------------------------

class _PoisonLoader:
    """List-of-batches loader that routes every batch through a chaos
    poison hook (the port's or the reference's)."""

    def __init__(self, batches, hooks=chaos):
        self.batches = batches
        self.hooks = hooks

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, (x, y) in enumerate(self.batches):
            x, y = self.hooks.poison_batch(i, [x, y])
            yield x, y


class TestSentryInFit:
    def test_nan_batch_skipped_and_training_survives(self, tmp_path):
        batches = _batches(n=8)
        model = _make_model()
        cb = ResilienceCallback(str(tmp_path / "ck"), save_every=2)
        with FaultPlan(nan_batch_steps=[3]) as plan:
            hist = model.fit(train_data=_PoisonLoader(batches), epochs=1,
                             verbose=0, callbacks=[cb])
        assert ("poison", 3) in plan.injected
        assert cb.sentry.skips == 1 and cb.sentry.rewinds == 0
        assert ("skip", 3) in cb.events
        assert np.isfinite(hist["loss"][-1])
        for k, v in _weights(model).items():
            assert torch.isfinite(v).all(), k

    def test_skip_restores_the_state_before_the_batch(self, tmp_path):
        """The poisoned update is undone exactly: the run equals one that
        never saw batch 3 (its Adam step count included)."""
        batches = _batches(n=6)
        model = _make_model()
        cb = ResilienceCallback(str(tmp_path / "ck"), save_every=100)
        with FaultPlan(nan_batch_steps=[3]):
            model.fit(_PoisonLoader(batches), verbose=0, callbacks=[cb])
        clean = _make_model()
        clean.fit(batches[:3] + batches[4:], verbose=0)
        _same(_weights(model), _weights(clean))

    def test_persistent_poison_rewinds_to_checkpoint(self, tmp_path):
        batches = _batches(n=10)
        model = _make_model()
        sentry = Sentry(max_consecutive_bad=3)
        cb = ResilienceCallback(str(tmp_path / "ck"), save_every=1,
                                sentry=sentry)
        with FaultPlan(nan_batch_steps=[4, 5, 6]):
            model.fit(train_data=_PoisonLoader(batches), epochs=1,
                      verbose=0, callbacks=[cb])
        assert sentry.skips == 2 and sentry.rewinds == 1
        assert ("rewind", 4) in cb.events
        for k, v in _weights(model).items():
            assert torch.isfinite(v).all(), k


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _token_batches(n=8, b=2, t=16, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(1, 256, (b, t + 1)).astype(np.int64)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _relative(entry, ckdir):
    """A corrupted file's path relative to its checkpoint directory (the
    two packages write into two directories)."""
    kind, *rest = entry
    if kind in ("bitflip", "truncate"):
        return (kind, os.path.relpath(rest[0], ckdir))
    return entry


def _jax_mlp():
    paddle.seed(0)
    net = jnn.Sequential(jnn.Linear(4, 16), jnn.ReLU(), jnn.Linear(16, 2))
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Adam(0.01, parameters=net.parameters()),
                  jnn.MSELoss())
    return model


class TestAgainstTheReference:
    @pytest.mark.parametrize("plan_kw", [
        dict(seed=3, nan_batch_steps=[2], inf_batch_steps=[5],
             corrupt_after_save={2: "bitflip"}),
        dict(seed=1, nan_batch_steps=[3, 4, 5], crash_on_save=4),
        dict(seed=2, delay_steps={1: 1e-3}, kill_at_step=6,
             corrupt_after_save={3: "truncate"})])
    def test_same_injected_log_and_events(self, tmp_path, plan_kw):
        batches = _batches(n=8)
        logs = {}
        for name, make, Plan, Callback, hooks, stop in (
                ("jax", _jax_mlp, JFaultPlan, JResilienceCallback, jchaos,
                 (JPreemption, jchaos.ChaosError)),
                ("torch", _make_model, FaultPlan, ResilienceCallback, chaos,
                 (SimulatedPreemption, ChaosError))):
            ckdir = str(tmp_path / name)
            cb = Callback(ckdir, save_every=1)
            plan = Plan(**plan_kw)
            raised = None
            with plan:
                try:
                    make().fit(_PoisonLoader(batches, hooks), verbose=0,
                               callbacks=[cb])
                except stop as e:
                    raised = type(e).__name__
            logs[name] = ([_relative(e, ckdir) for e in plan.injected],
                          cb.events, raised, sorted(os.listdir(ckdir)),
                          cb.sentry.stats())
        assert logs["torch"] == logs["jax"]

    def test_a_jax_checkpoint_directory_resumes_in_the_port(self, tmp_path):
        """A JAX tiny-Llama fit killed at step 3 of 8; the port's callback
        resumes from its checkpoints and finishes the epoch to the JAX
        uninterrupted run's weights."""
        data = _token_batches()

        def jax_model():
            paddle.seed(0)
            net = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
            m = paddle.Model(net)
            m.prepare(paddle.optimizer.AdamW(1e-3,
                                             parameters=net.parameters()),
                      jnn.CrossEntropyLoss())
            return m

        ref = jax_model()
        init = {k: np.asarray(v.numpy())
                for k, v in ref.network.state_dict().items()}
        ref.fit(data, verbose=0)
        want = {k: np.asarray(v.numpy())
                for k, v in ref.network.state_dict().items()}
        ckdir = str(tmp_path / "ck")
        with pytest.raises(JPreemption):
            with JFaultPlan(kill_at_step=3):
                jax_model().fit(data, verbose=0, callbacks=[
                    JResilienceCallback(ckdir, save_every=1)])
        # the port's model starts from other weights: the checkpoint
        # must carry everything
        net = from_jax_state_dict({k: v * 0 for k, v in init.items()},
                                  LlamaConfig.tiny(), device="cpu")
        model = pt.Model(net)
        model.prepare(pt.optimizer.AdamW(1e-3, parameters=net.parameters()),
                      tnn.CrossEntropyLoss())
        cb = ResilienceCallback(ckdir, save_every=1)
        model.fit(data, verbose=0, callbacks=[cb])
        assert cb.events[0] == ("resume", 3)
        assert model._optimizer._step_count == 8
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0,
                                       atol=WEIGHT_TOL, err_msg=k)
