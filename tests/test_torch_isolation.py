"""Guards of the PyTorch port (paddle_tpu_torch).

- importing the package and every module in it (the static-graph
  frontend ``static``, the ``nn`` layers and gradient clipping, the
  optimizers and learning-rate schedulers of ``optimizer``, the
  recomputation of ``distributed``, the CUDA-graph steps of ``jit``,
  the compile accounting, metrics registry and StepTimer of
  ``observability``, the fault plan, checkpointer, sentry and callback
  of ``resilience``, the fleet router and trace replay of ``serving``,
  the ``hapi`` training loop, the datasets and loaders of ``io``,
  ``metric``, ``framework``'s save and load, and the ``inference`` front
  door included; they are copies, not imports) loads no ``jax*``
  module and nothing of the JAX package (``paddle_tpu`` /
  ``paddle_tpu.*``), and no source file names one;
- its entry points run on ``cuda`` unless told otherwise, and raise
  where there is no GPU instead of falling back to the CPU;
- options of later slices raise ``NotImplementedError``;
- ``chip_smoke.py`` fails, printing no result, without a CUDA device.
"""
import ast
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import resolve_device, static
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
from paddle_tpu_torch.nn.layer import EMPTY, Embedding, LayerNorm, Linear
from paddle_tpu_torch.nn.transformer import (MultiHeadAttention,
                                             TransformerEncoderLayer)
from paddle_tpu_torch.serving import Endpoint, Engine, ServingConfig
from paddle_tpu_torch.serving.engine import LATER_SLICE_OPTIONS

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "paddle_tpu_torch"

IMPORT_ALL = """
import json, pkgutil, importlib, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(json.dumps({"bad": bad, "ours": sorted(
    n for n in sys.modules if n.startswith("paddle_tpu_torch"))}))
"""
# the subpackages the walk must reach (each with at least one module)
SUBPACKAGES = ("distributed", "framework", "hapi", "inference", "io", "jit",
               "kernels", "metric", "models", "nn", "observability",
               "optimizer", "quantization", "resilience", "serving",
               "static")


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")


class TestNoJax:
    def test_import_loads_no_jax_and_no_jax_package(self):
        out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                             capture_output=True, text=True, timeout=120,
                             check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["bad"] == []
        # every module was imported, the static frontend and nn included
        want = {"paddle_tpu_torch." + ".".join(
            p.relative_to(PACKAGE).with_suffix("").parts)
            for p in PACKAGE.rglob("*.py") if p.name != "__init__.py"}
        assert want <= set(res["ours"])
        for sub in SUBPACKAGES:
            # a subpackage of modules had one imported; ``inference`` is
            # its __init__ alone
            modules = [p for p in (PACKAGE / sub).rglob("*.py")
                       if p.name != "__init__.py"]
            assert f"paddle_tpu_torch.{sub}" in res["ours"], sub
            assert not modules or any(
                n.startswith(f"paddle_tpu_torch.{sub}.")
                for n in res["ours"]), sub

    def test_source_walk_covers_every_subpackage(self):
        walked = {p.relative_to(PACKAGE).parts[0]
                  for p in PACKAGE.rglob("*.py") if p.parent != PACKAGE}
        assert set(SUBPACKAGES) <= walked

    @pytest.mark.parametrize("path", sorted(
        str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")))
    def test_source_names_no_jax_module(self, path):
        # also catches imports inside functions, which an import-time
        # check never runs
        tree = ast.parse((ROOT / path).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(map(_is_forbidden, names)), (path, names)


class TestDevice:
    @pytest.fixture
    def no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_default_is_cuda_and_raises_without_a_gpu(self, no_gpu):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda:0")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LlamaForCausalLM(LlamaConfig.tiny())
        for build in (lambda: Linear(8, 4), lambda: Embedding(16, 8),
                      lambda: LayerNorm(8),
                      lambda: MultiHeadAttention(8, 2),
                      lambda: TransformerEncoderLayer(8, 2, 16),
                      lambda: BertForPretraining(BertConfig.tiny()),
                      lambda: static.create_parameter([4], "float32")):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()

    def test_cpu_only_when_asked(self, no_gpu):
        assert resolve_device("cpu") == torch.device("cpu")
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        assert model.lm_head.weight.device.type == "cpu"
        assert Engine(model).pool.layers[0][0].device.type == "cpu"
        # the sampled step's per-slot state lives on the model's device
        eng = Endpoint(model).engine
        assert {t.device.type for t in (eng._temps, eng._top_ks, eng._top_ps,
                                        eng._keys, eng._counters)} == {"cpu"}

    @pytest.mark.parametrize("build", [
        lambda: Linear(64, 32, device="cpu"),
        lambda: Embedding(64, 32, device="cpu")])
    def test_layer_weights_drawn_by_default(self, build):
        # nothing left uninitialized unless asked for (init=EMPTY)
        w = build().weight.detach()
        assert torch.isfinite(w).all()
        assert 0.01 < float(w.std()) < 0.03              # init_std 0.02
        gen = torch.Generator().manual_seed(0)
        a = Linear(64, 32, device="cpu", init=gen).weight
        b = Linear(64, 32, device="cpu",
                   init=torch.Generator().manual_seed(0)).weight
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="init"):
            Linear(4, 4, device="cpu", init="zeros")
        assert Linear(4, 4, device="cpu", init=EMPTY).weight.shape == (4, 4)

    def test_unknown_device_type_rejected(self):
        with pytest.raises(ValueError, match="unsupported device"):
            resolve_device("meta")


@pytest.fixture(scope="module")
def tiny_model():
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)


class TestLaterSliceOptionsRaise:
    @pytest.mark.parametrize("option,value", [
        ("mesh", {"tp": 2}), ("xray_on_start", True), ("shardplan", True)])
    def test_serving_config(self, tiny_model, option, value):
        with pytest.raises(NotImplementedError, match=option):
            Engine(tiny_model, ServingConfig(**{option: value}))

    def test_unfused_path_is_ported(self, tiny_model):
        """``fused_kernels=False`` no longer raises: the engine serves a
        request through the unfused steps, with the fused engine's
        tokens."""
        prompt = np.arange(1, 12)
        got = {}
        for fused in (False, True):
            eng = Engine(tiny_model, ServingConfig(fused_kernels=fused,
                                                   num_blocks=16))
            req = eng.submit(prompt, max_new_tokens=5)
            eng.run_until_complete()
            eng.pool.check_leaks()
            assert req.finish_reason == "length"
            got[fused] = req.generated
        assert got[False] == got[True]
        assert "fused_kernels" not in LATER_SLICE_OPTIONS

    def test_speculative_is_ported(self, tiny_model):
        """``speculative`` no longer raises: a bare draft model is wrapped
        as ``SpeculativeConfig(draft_model=d, num_draft_tokens=4)``."""
        from paddle_tpu_torch.serving import SpeculativeConfig

        draft = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                                 device="cpu", seed=1)
        eng = Engine(tiny_model, ServingConfig(speculative=draft,
                                               num_blocks=16))
        assert eng.spec == SpeculativeConfig(draft_model=draft,
                                             num_draft_tokens=4)
        assert "speculative" not in LATER_SLICE_OPTIONS


class TestSubmitSamplingAndStreaming:
    """The submit arguments that raised until sampling and streaming
    were ported, each with its behaviour now: a temperature (or
    ``do_sample``, temperature 1) samples from a seeded key; ``top_k``,
    ``top_p`` or ``seed`` alone stay greedy; ``on_token`` streams."""

    @pytest.mark.parametrize("kwargs,temperature", [
        ({"temperature": 0.8, "seed": 1}, 0.8), ({"do_sample": True}, 1.0),
        ({"top_k": 5}, None), ({"top_p": 0.9}, None), ({"seed": 3}, None),
        ({"on_token": "list"}, None)])
    def test_submit(self, tiny_model, kwargs, temperature):
        prompt = np.arange(1, 5)
        eng = Engine(tiny_model, ServingConfig())
        greedy = eng.submit(prompt, max_new_tokens=6)
        got = []
        if kwargs.get("on_token") == "list":
            kwargs = {"on_token": got.append}
        req = eng.submit(prompt, max_new_tokens=6, **kwargs)
        eng.run_until_complete()
        eng.pool.check_leaks()
        assert req.finish_reason == "length" and len(req.generated) == 6
        if temperature is None:
            assert req.sampling is None
            assert req.generated == greedy.generated
        else:
            assert req.sampling.temperature == temperature
            assert req.sampling_key is not None
        if got:
            assert got == req.generated


class TestChipSmokeNeedsAGpu:
    def _run(self, cwd):
        return subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
            text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                         "CUDA_VISIBLE_DEVICES": ""})

    def test_fails_without_cuda(self):
        out = self._run(ROOT)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

    def test_fails_alone(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        out = self._run(tmp_path)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
