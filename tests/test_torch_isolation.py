"""Guards of the PyTorch port (paddle_tpu_torch).

- importing the package and every module in it loads no ``jax*`` module
  and nothing of the JAX package (``paddle_tpu`` / ``paddle_tpu.*``);
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

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import Engine, ServingConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "paddle_tpu_torch"

IMPORT_ALL = """
import json, pkgutil, importlib, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(json.dumps({"bad": bad, "n": sum(n.startswith("paddle_tpu_torch")
                                       for n in sys.modules)}))
"""


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")


class TestNoJax:
    def test_import_loads_no_jax_and_no_jax_package(self):
        out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                             capture_output=True, text=True, timeout=120,
                             check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["bad"] == []
        assert res["n"] >= 15          # every module was imported

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

    def test_cpu_only_when_asked(self, no_gpu):
        assert resolve_device("cpu") == torch.device("cpu")
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        assert model.lm_head.weight.device.type == "cpu"
        assert Engine(model).pool.layers[0][0].device.type == "cpu"

    def test_unknown_device_type_rejected(self):
        with pytest.raises(ValueError, match="unsupported device"):
            resolve_device("meta")


@pytest.fixture(scope="module")
def tiny_model():
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)


class TestLaterSliceOptionsRaise:
    @pytest.mark.parametrize("option,value", [
        ("speculative", object()), ("kv_cache_dtype", "int8"),
        ("kv_cache_dtype", "fp8"), ("weight_dtype", "int8"),
        ("mesh", {"tp": 2}), ("xray_on_start", True),
        ("shardplan", True), ("fused_kernels", False)])
    def test_serving_config(self, tiny_model, option, value):
        with pytest.raises(NotImplementedError, match=option):
            Engine(tiny_model, ServingConfig(**{option: value}))

    @pytest.mark.parametrize("kwargs", [
        {"temperature": 0.8}, {"do_sample": True}, {"top_k": 5},
        {"top_p": 0.9}, {"seed": 3}, {"on_token": print},
        {"token_deadline_s": 1.0}, {"deadline_s": 5.0}, {"priority": 1}])
    def test_submit(self, tiny_model, kwargs):
        eng = Engine(tiny_model, ServingConfig())
        with pytest.raises(NotImplementedError):
            eng.submit(np.arange(1, 5), max_new_tokens=2, **kwargs)
        assert not eng.has_work()


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
