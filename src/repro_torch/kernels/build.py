"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all
started together) into ``build/<name>-<digest>.so``, a shared library
with a plain C interface that ``ctypes`` loads.  No PyTorch header is
included, so a build takes seconds, not minutes.  The digest covers the
source and every header in ``csrc/``, so an edited kernel rebuilds and
an unchanged one is reused within the same checkout.  The build
directory is listed in ``.gitignore``.

Nothing is built when this module is imported: the first call of
``load`` builds, and it needs ``nvcc`` (``$CUDA_HOME/bin`` or
``/usr/local/cuda/bin``) and a CUDA card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("block_diff_attn", "paged_attn")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # name -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "the machine with the card")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Build (in parallel, once per source version) and load the named
    kernel libraries; returns {name: CDLL}."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    with _lock:
        missing = [n for n in names if n not in _libs]
        if not missing:
            return {n: _libs[n] for n in names}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in missing:
            out = BUILD_DIR / f"{n}-{_digest(n)}.so"
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
                 str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[n] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in missing:
            _libs[n] = ctypes.CDLL(str(BUILD_DIR / f"{n}-{_digest(n)}.so"))
        return {n: _libs[n] for n in names}


_fns: dict[tuple[str, str], object] = {}


def function(lib: str, name: str, argtypes):
    """The C entry point ``name`` of kernel library ``lib`` with its
    ``ctypes`` signature declared (once per process); returns an int
    ``cudaError_t``."""
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(load((lib,))[lib], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib, name)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
