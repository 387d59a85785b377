"""Build and load the port's CUDA kernels (``paddle_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library for ``sm_90a``, then loaded with
``ctypes``: no PyTorch headers, so one source builds in seconds.  The
libraries land in ``build/paddle_tpu_torch/`` beside the package (a
directory git ignores), named by a hash of the source and the flags, so
a source is rebuilt only when it changes.  ``build_all()`` starts one
``nvcc`` per source at once and waits for all of them; a source named
in :data:`SPLIT` compiles as several translation units at once (each
with its unit's macro defined: the source says which of its instances
each unit holds), linked into its one library, its ``-Xptxas -v`` log
the units' logs in order.

Nothing here runs at import time: the CPU tests import every module on
a machine that has neither ``nvcc`` nor a GPU.

The wrappers pass pointers as ``c_void_p`` (``tensor.data_ptr()``) and
launch on PyTorch's current stream; every C entry point returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: source: (macro, units) of the sources compiled as several units
SPLIT = {"paged_attention": ("PD_UNIT", 10),
         "flash_attention": ("FA_UNIT", 4),
         "chunked_prefill": ("CP_UNIT", 4)}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(SPLIT.get(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _commands(name, tmp):
    """The ``nvcc`` commands that build ``name`` into ``tmp``: one, or
    one a unit (objects beside ``tmp``) and the link after them."""
    src = str(CSRC / f"{name}.cu")
    if name not in SPLIT:
        return [[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]], []
    macro, units = SPLIT[name]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_suffix(f".u{u}.o") for u in range(units)]
    compile_ = [[_nvcc(), *flags, "-c", f"-D{macro}={u}", "-o", str(o), src]
                for u, o in enumerate(objs)]
    link = [_nvcc(), "-shared", "-gencode", NVCC_FLAGS[1], "-o", str(tmp),
            *map(str, objs)]
    return compile_, [link, objs]


def build_all(names=None) -> dict:
    """Compile every stale source in parallel (one ``nvcc`` each, or one
    a unit of a :data:`SPLIT` source) and return ``{name: seconds}``
    for those built, each from the start to its library; sources whose
    library is current are skipped.  Raises with the compiler's output
    on failure.  ``nvcc``'s ``-Xptxas -v`` report goes to
    ``<library>.log``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compile_, link = _commands(name, tmp)
        jobs[name] = dict(tmp=tmp, out=out, link=link, logs=[], procs=[
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in compile_])
    took, failed = {}, []
    while jobs:
        for name, job in list(jobs.items()):
            if any(p.poll() is None for p in job["procs"]):
                continue
            logs = [p.communicate()[0] for p in job["procs"]]
            bad = [log for p, log in zip(job["procs"], logs)
                   if p.returncode != 0]
            if job["link"] and not bad:
                cmd, objs = job["link"]
                r = subprocess.run(cmd, capture_output=True, text=True)
                for o in objs:
                    o.unlink(missing_ok=True)
                if r.returncode != 0:
                    bad.append(r.stdout + r.stderr)
            del jobs[name]
            job["out"].with_suffix(".log").write_text("".join(logs))
            if bad:
                failed.append(f"{name}.cu:\n" + "\n".join(bad))
                continue
            os.replace(job["tmp"], job["out"])
            took[name] = time.perf_counter() - t0
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return took


def build_copies(name: str, texts: dict, root: Path) -> dict:
    """Compile copies of ``csrc/<name>.cu`` for scripts that time or
    stress a kernel's variants: ``texts`` is {variant: source text}; each
    builds with the flags above beside copies of the headers in
    ``root/<variant>/``, all at once.  Returns {variant: library path};
    raises with the compiler's output on failure."""
    procs = {}
    for variant, text in texts.items():
        d = root / variant
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            (d / header.name).write_bytes(header.read_bytes())
        (d / f"{name}.cu").write_text(text)
        out = d / f"lib{name}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(d / f"{name}.cu")]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), out)
    paths = {}
    for variant, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variant}:\n{log}")
        paths[variant] = out
    return paths


def use_library(name: str, path):
    """Route the wrappers' calls of ``csrc/<name>.cu`` to the library at
    ``path`` (a copy from :func:`build_copies`)."""
    with _lock:
        _libs[name] = ctypes.CDLL(str(path))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def bind(name: str, fn: str, argtypes: list):
    """``fn`` of ``csrc/<name>.cu`` with its ctypes signature set
    (every entry point returns an int error code)."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def require_cuda(what: str, *tensors, contiguous: bool = True):
    """Raise unless every tensor lies on one CUDA device and (unless the
    kernel takes strides) is contiguous: the kernels index raw
    pointers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (the kernels' grid plans)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{t.dtype}")
    return code


class LaunchCounter:
    """Plain-integer launch counts, one per kernel wrapper.  A wrapper
    adds one where it launches its kernel and nowhere else, so a run can
    show which kernels its path went through.  A wrapper whose kernel
    has several compiled instances (widths, producers) also names the
    instance it launched, tallied apart under ``name@instance``
    (:meth:`by_instance`), so that a run shows which instances ran.

    A CUDA graph's replay launches its kernels without running their
    wrappers, so a graph step (``paddle_tpu_torch.jit.GraphStep``)
    takes the counts its capture added (:meth:`mark`, :meth:`since`),
    puts the counts back as they were before its warmup and capture
    (:meth:`restore`), and adds that delta at every replay
    (:meth:`replay`): a replayed step counts what an eager one does."""

    def __init__(self):
        self.counts: dict = {}
        self.instances: dict = {}

    def add(self, name: str, instance: str | None = None):
        self.counts[name] = self.counts.get(name, 0) + 1
        if instance is not None:
            key = f"{name}@{instance}"
            self.instances[key] = self.instances.get(key, 0) + 1

    def reset(self):
        self.counts.clear()
        self.instances.clear()

    def mark(self) -> tuple:
        """The counts as they stand, for :meth:`since` and
        :meth:`restore`."""
        return dict(self.counts), dict(self.instances)

    def since(self, mark: tuple) -> tuple:
        """(counts, instances) added after ``mark``."""
        return tuple({k: n - old.get(k, 0) for k, n in now.items()
                      if n != old.get(k, 0)}
                     for now, old in zip((self.counts, self.instances), mark))

    def restore(self, mark: tuple):
        """Put the counts back as they were at ``mark``."""
        for now, old in zip((self.counts, self.instances), mark):
            now.clear()
            now.update(old)

    def replay(self, delta: tuple):
        """Add ``delta`` (from :meth:`since`): one replay of a captured
        graph."""
        for now, add in zip((self.counts, self.instances), delta):
            for k, n in add.items():
                now[k] = now.get(k, 0) + n

    def snapshot(self) -> dict:
        return dict(self.counts)

    def by_instance(self) -> dict:
        return dict(self.instances)


launches = LaunchCounter()
