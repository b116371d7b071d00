"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build
happens at first use, under ``build/repro_torch/`` at the repository root,
keyed on a hash of the sources and flags, so ``python3 chip_smoke.py`` alone
builds what it runs.  No PyTorch header is compiled, which keeps a build to
seconds.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (see each source's contract)
SIGNATURES = {
    "decode_step_launch": [_P] * 14 + [_I] * 7 + [_F, _P],
    "flow_score_launch": [_P] * 18 + [_I] * 6 + [_P],
    "int_flow_score_launch": [_P] * 20 + [_I] * 12 + [_P],
    "int_flow_score_fast_path": [_P] * 4 + [_I] * 4,
    "chimera_attention_launch": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 2 + [_P],
    "chimera_attention_long_launch": [_P] * 8 + [_I] * 7 + [_F] + [_I] * 2 + [_P],
    "chimera_attention_bwd_launch": [_P] * 14 + [_I] * 7 + [_F] + [_I] * 2 + [_P],
    "chimera_attention_bwd_bf16_launch": [_P] * 13 + [_I] * 7 + [_F] + [_I] * 2 + [_P],
    "chimera_attention_bwd_bf16_scratch": [_I] * 6,
    "window_attention_launch": [_P] * 5 + [_I] * 7 + [_F] + [_I] + [_P],
    "window_attention_noncausal_launch": [_P] * 5 + [_I] * 7 + [_F] + [_I] + [_P],
    "window_attention_bwd_launch": [_P] * 10 + [_I] * 7 + [_F] + [_I] + [_P],
    "window_attention_noncausal_bwd_launch": [_P] * 10 + [_I] * 7 + [_F] + [_I] + [_P],
    "empty_launch": [_I, _P],
}

# return types other than int
RESTYPES = {"chimera_attention_bwd_bf16_scratch": ctypes.c_longlong}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if it built
build_logs: dict = {}  # source name -> nvcc's output (with -Xptxas -v), if this process built


def find_nvcc() -> str:
    """``$NVCC``, else ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``, else PATH."""
    candidates = [os.environ.get("NVCC")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels of "
        "repro_torch need the CUDA toolkit to build"
    )


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash(csrc: Path = CSRC) -> str:
    """A hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libchimera_kernels_{source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link them; returns the library path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for src, obj, p in procs:
            log, _ = p.communicate()
            build_logs[src.name] = log
            if verbose or p.returncode:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        tmp_lib = Path(tmp) / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    return _lib


CUDA_ERROR_INVALID_VALUE = 1


def check(err: int, name: str) -> None:
    """Raise for a launcher's nonzero return: cudaErrorInvalidValue is a shape,
    layout or alignment the kernel does not take (see its source's contract)."""
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: the kernel does not take these shapes (cudaErrorInvalidValue; "
                         f"see its source's contract)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()
