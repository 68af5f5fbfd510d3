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
``ops/merge.py``, ``ops/window.py``, ``ops/stats.py``, ``ops/scan.py``
and ``ops/bucket.py``: each adds one
right after its launch returned without error, and nowhere else.  The
staged forms of three kernels (``ops/stream.py``) count apart from their
row forms: ``bucket_stats_ring``, ``range_stats_ring`` and
``resample_ema_ring``.
Every wrapper launches through :func:`launch`, which makes the
operands' device the current CUDA device first: a launch onto a stream
of another device than the current one fails, and a shard of a
``DistributedTSDF`` may lie on any card.
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
           "index_scan.cu", "resample_ema.cu", "merge_rank.cu", "cumsum3.cu",
           "legacy_stats.cu", "bucket_stats.cu", "ema_scan.cu")
HEADERS = ("common.cuh", "ring.cuh", "window.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: kernel name -> launches made by its wrapper
launches: Dict[str, int] = {"asof_merge": 0, "range_stats": 0,
                            "ema_ladder": 0, "last_valid_index": 0,
                            "first_valid_index": 0, "last_valid_scan": 0,
                            "resample_ema": 0, "asof_merge_lookback": 0,
                            "merge_rank": 0, "cumsum3": 0,
                            "legacy_stats": 0, "bucket_stats": 0,
                            "bucket_stats_ring": 0, "range_stats_ring": 0,
                            "resample_ema_ring": 0, "ema_scan": 0}

_lock = threading.Lock()
_lib = None
#: compiler output of the build this process made (ptxas register and
#: shared-memory report), empty when an existing library was loaded
build_log: List[str] = []
#: libraries this process compiled (nvcc runs of :func:`build`)
builds = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tempo_asof_merge": [_P] * 11 + [_I] * 5 + [_P],
    "tempo_asof_merge_lookback": [_P] * 13 + [_I] * 7 + [_P],
    "tempo_merge_rank": [_P] * 4 + [_I] * 6 + [_P],
    "tempo_cumsum3": [_P] * 5 + [_I, _I, _P],
    "tempo_range_stats": [_P] * 8 + [_I] * 7 + [_P],
    "tempo_legacy_stats": [_P] * 7 + [_I] * 6 + [_P],
    "tempo_bucket_stats": [_P] * 8 + [_I] * 3 + [_P],
    "tempo_bucket_stats_ring": [_P] * 7 + [_I] * 5 + [_P],
    "tempo_range_stats_ring": [_P] * 8 + [_I] * 10 + [_P],
    "tempo_range_centres": [_P] * 6 + [_I] * 3 + [_P],
    "tempo_ema_ladder": [_P, _P, ctypes.c_float, _P, _P, _I, _I, _P],
    "tempo_ema_scan": [_P, _P, ctypes.c_double] + [_P] * 3 + [_I] * 6 + [_P],
    "tempo_ema_chain_probe": [_P, _P, _I, _I, _P],
    "tempo_last_valid_index": [_P, _P, _I, _I, _P],
    "tempo_first_valid_index": [_P, _P, _I, _I, _P],
    "tempo_last_valid_scan": [_P] * 4 + [_I, _I, _P],
    "tempo_resample_ema": [_P] * 3 + [_I, ctypes.c_float, ctypes.c_float]
                          + [_P] * 3 + [_I, _I, _P],
    "tempo_resample_ema_ring": [_P] * 3 + [_I, ctypes.c_float,
                                           ctypes.c_float]
                               + [_P] * 2 + [_I] * 4 + [_P],
    "tempo_error_string": [_I],
}
#: the staged forms' and the sequential EMA's shared-memory totals, as
#: the kernels compute them, the range-stats staged form's blocks an SM,
#: the merge walk's step and column limit, the row form's, the walk's
#: and the tile join's shared memory a block, the row limits of the
#: ``cumsum3``, EMA, bucket-stats and range-stats kernels and the
#: range-stats row form's window (64-bit results)
_SMEM_SIGNATURES = {
    "tempo_range_row_window": [],
    "tempo_range_max_lanes": [],
    "tempo_asof_walk_step": [],
    "tempo_asof_walk_cols": [],
    "tempo_range_row_smem": [],
    "tempo_asof_walk_smem": [],
    "tempo_asof_tile_smem": [],
    "tempo_cumsum3_max_lanes": [],
    "tempo_ema_row_max": [],
    "tempo_ema_max_lanes": [],
    "tempo_bucket_max_lanes": [],
    "tempo_bucket_ring_smem": [_I] * 3,
    "tempo_range_ring_smem": [_I] * 5,
    "tempo_range_ring_occupancy": [_I] * 2,
    "tempo_resample_ring_smem": [_I] * 3,
    "tempo_ema_scan_smem": [_I] * 5,
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
    global builds
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
    builds += 1
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
            for name, argtypes in _SMEM_SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_longlong
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


def launch(kernel: str, device, entry: str, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current
    stream of ``device``, with ``device`` made the current CUDA device
    for the call, then :func:`check` the returned code (which counts the
    launch of ``kernel``)."""
    with torch.cuda.device(device):
        code = getattr(lib(), entry)(*args, stream_handle(device))
    check(code, kernel)


def ptr(t) -> int:
    """Device pointer of a tensor, or None (NULL) for None."""
    return None if t is None else t.data_ptr()


def asof_walk_step() -> int:
    """Merged positions a step of the merge kernel's row walk."""
    return lib().tempo_asof_walk_step()


def asof_walk_cols() -> int:
    """Most right columns the merge kernel's row walk takes (a validity
    bit each in a 32-bit word)."""
    return lib().tempo_asof_walk_cols()


def range_row_smem() -> int:
    """Shared memory of a range-stats row-form block at its widest
    window, static and dynamic, as the compiler laid the kernel out."""
    return lib().tempo_range_row_smem()


def asof_walk_smem() -> int:
    """Shared memory of a block of the merge walk with the sid and
    sequence planes, static and dynamic."""
    return lib().tempo_asof_walk_smem()


def asof_tile_smem() -> int:
    """Shared memory of a block of the lookback kernels' tile join."""
    return lib().tempo_asof_tile_smem()


def cumsum3_max_lanes() -> int:
    """Longest row the ``cumsum3`` kernel takes (int32 lane indices: its
    class stages take any length)."""
    return lib().tempo_cumsum3_max_lanes()


def ema_row_max() -> int:
    """Longest row the EMA and resample-EMA kernels take in one launch (a
    row in one block); longer rows take their tiled stages."""
    return lib().tempo_ema_row_max()


def ema_max_lanes() -> int:
    """Longest row the EMA and resample-EMA kernels take (int32 lane
    indices: their class stages take any length)."""
    return lib().tempo_ema_max_lanes()


def range_row_window() -> int:
    """Lanes the range-stats row form's shared-memory window holds; a tile
    and its halo past it walk several windows."""
    return lib().tempo_range_row_window()


_sms: Dict[int, int] = {}


def sm_count(device) -> int:
    """The SMs of ``device``'s card (cached: a plan made inside a CUDA
    graph capture reads nothing from the card)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


_ring_blocks: Dict[tuple, int] = {}


def range_ring_blocks(device, tile: int, smem: int) -> int:
    """Blocks of the range-stats staged form the card holds at once at
    ``tile / 4`` threads and ``smem`` bytes of shared memory a block: its
    SM count times the blocks an SM holds, as the card's occupancy
    calculator gives them (cached by device and shape)."""
    device = torch.device(device)
    key = (device.index, int(tile), int(smem))
    if key not in _ring_blocks:
        with torch.cuda.device(device):
            per_sm = lib().tempo_range_ring_occupancy(int(tile), int(smem))
        if per_sm < 1:
            raise RuntimeError(f"range-stats staged form: no block of "
                               f"{tile // 4} threads and {smem} B of shared "
                               f"memory fits an SM ({per_sm})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _ring_blocks[key] = int(per_sm) * int(sms)
    return _ring_blocks[key]


def range_max_lanes() -> int:
    """Longest row the range-stats kernel takes (2^30: a lane plus a row
    bound stays an int32; its clip counts are exact integers)."""
    return lib().tempo_range_max_lanes()


def bucket_max_lanes() -> int:
    """Longest row the bucket-stats row form takes (int32 lane indices:
    its class stages take any length)."""
    return lib().tempo_bucket_max_lanes()
