"""Build, load and count the port's CUDA kernels.

The sources live in ``tempo_tpu_torch/csrc``.  At first use each
``.cu`` file compiles with its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object, and the objects link into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library's name carries a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads the existing file.  The build
directory (``tempo_tpu_torch/_build`` unless ``TEMPO_TPU_KERNEL_BUILD_DIR``
says otherwise) is listed in ``.gitignore``.

``-fmad=false`` keeps nvcc from contracting ``a*b+c`` into fused
multiply-adds anywhere; the kernels also spell their accumulator lines
with round-to-nearest intrinsics, so their float results round like the
plain versions'.

``launches`` counts, per kernel, the launches made by the wrappers in
``ops/merge.py``, ``ops/window.py``, ``ops/scan.py`` and
``ops/bucket.py``: each adds one
right after its launch returned without error, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

import torch

from tempo_tpu_torch import config

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("asof_merge.cu", "range_stats.cu", "ema_ladder.cu",
           "index_scan.cu", "resample_ema.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: kernel name -> launches made by its wrapper
launches: Dict[str, int] = {"asof_merge": 0, "range_stats": 0,
                            "ema_ladder": 0, "last_valid_index": 0,
                            "first_valid_index": 0, "last_valid_scan": 0,
                            "resample_ema": 0}

_lock = threading.Lock()
_lib = None
#: compiler output of the build this process made (ptxas register and
#: shared-memory report), empty when an existing library was loaded
build_log: List[str] = []

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tempo_asof_merge": [_P] * 12 + [_I] * 5 + [_P],
    "tempo_range_stats": [_P] * 6 + [_I] * 7 + [_P],
    "tempo_ema_ladder": [_P, _P, ctypes.c_float, _P, _P, _I, _I, _P],
    "tempo_ema_smem_limit": [],
    "tempo_last_valid_index": [_P, _P, _I, _I, _P],
    "tempo_first_valid_index": [_P, _P, _I, _I, _P],
    "tempo_last_valid_scan": [_P] * 4 + [_I, _I, _P],
    "tempo_resample_ema": [_P] * 3 + [_I, ctypes.c_float, ctypes.c_float]
                          + [_P] * 3 + [_I, _I, _P],
    "tempo_error_string": [_I],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build_dir() -> Path:
    env = config.get("TEMPO_TPU_KERNEL_BUILD_DIR")
    return Path(env) if env else CSRC.parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Path of the built library, compiling it first when missing."""
    out_dir = build_dir()
    lib_path = out_dir / f"libtempo_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (Path(src).stem + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    build_log[:] = [log for log in logs if log.strip()]
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.tempo_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise on a nonzero CUDA error code from a launch, else count the
    launch."""
    if code != 0:
        msg = lib().tempo_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
    launches[kernel] += 1


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    """Device pointer of a tensor, or None (NULL) for None."""
    return None if t is None else t.data_ptr()
