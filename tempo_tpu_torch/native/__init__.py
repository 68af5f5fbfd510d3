"""ctypes loader of the native C++ packing engine (``packer.cpp``).

Counterpart of ``tempo_tpu/native``.  At first use ``packer.cpp``
compiles with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into the
port's build directory (``TEMPO_TPU_KERNEL_BUILD_DIR``, default
``tempo_tpu_torch/_build``), through a temporary name and an atomic
rename, so processes that build at once never load each other's
half-written output; a source newer than the library rebuilds it.

There is no fallback: a build or load that fails raises ``RuntimeError``
(with the compiler's output).  Only ``TEMPO_TPU_NATIVE=0`` sends
``packing`` to its numpy path.  Both knobs, ``TEMPO_TPU_NATIVE`` and
``TEMPO_TPU_NATIVE_THREADS``, are read at every call, so one process can
run both paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tempo_tpu_torch import config

SRC = Path(__file__).resolve().parent / "packer.cpp"
LIB_NAME = "libtempo_packer.so"
#: the C++ compiler, and its flags
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded: dict = {}          # library path -> loaded handle

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def enabled() -> bool:
    """Whether ``packing`` takes the native engine (``TEMPO_TPU_NATIVE``,
    default on)."""
    return config.get_bool("TEMPO_TPU_NATIVE", True)


def threads() -> int:
    """Worker threads of one native call (``TEMPO_TPU_NATIVE_THREADS``,
    default ``os.cpu_count()``)."""
    return max(1, config.get_int("TEMPO_TPU_NATIVE_THREADS",
                                 os.cpu_count() or 1))


def build() -> Path:
    """Path of the built library, compiling it first when it is missing
    or older than its source."""
    # the CUDA kernels' build directory (imported here: ``ops`` imports
    # ``packing``, which imports this module)
    from tempo_tpu_torch.ops.cuda_lib import build_dir

    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists() and \
            lib_path.stat().st_mtime >= SRC.stat().st_mtime:
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(
                f"native packer build failed: cannot run {CXX!r} ({e}); "
                f"set TEMPO_TPU_NATIVE=0 for the numpy path") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native packer build failed ({CXX} exit "
                f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded engine (built at first use); raises ``RuntimeError`` when
    it cannot be built or loaded."""
    with _lock:
        path = build()
        handle = _loaded.get(path)
        if handle is None:
            try:
                handle = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(
                    f"native packer load failed ({path}): {e}") from e
            cp = ctypes.c_char_p
            i64, n_thr = ctypes.c_int64, ctypes.c_int
            handle.tempo_sort_layout.argtypes = [
                _I64P, _I64P, _F64P, _I64P, i64, i64, _I64P, _I64P, n_thr]
            handle.tempo_take.argtypes = [cp, _I64P, i64, i64, cp, n_thr]
            handle.tempo_pack.argtypes = [cp, _I64P, i64, i64, i64, cp, cp,
                                          n_thr]
            handle.tempo_unpack.argtypes = [cp, _I64P, i64, i64, i64, cp,
                                            n_thr]
            for fn in (handle.tempo_sort_layout, handle.tempo_take,
                       handle.tempo_pack, handle.tempo_unpack):
                fn.restype = None
            _loaded[path] = handle
    return handle


def _i64p(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.cast(None, _I64P)
    return a.ctypes.data_as(_I64P)


def _f64p(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.cast(None, _F64P)
    return a.ctypes.data_as(_F64P)


def _bytes_ptr(a: np.ndarray):
    return ctypes.cast(a.ctypes.data, ctypes.c_char_p)


def sort_layout(key_ids: np.ndarray, ts_ns: np.ndarray,
                seq: Optional[np.ndarray], n_series: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, starts)`` of the (key, ts, seq) total order: the native
    ``np.lexsort((seq, ts_ns, key_ids))`` plus bincount.  Integer
    sequence columns take the exact int64 comparator (values above 2^53
    must not round through float64); float ones sort NaN last."""
    handle = lib()
    n = key_ids.shape[0]
    key_ids = np.ascontiguousarray(key_ids, dtype=np.int64)
    ts_ns = np.ascontiguousarray(ts_ns, dtype=np.int64)
    if n and (int(key_ids.min()) < 0 or int(key_ids.max()) >= n_series):
        # the C++ writes are unchecked; fault here as bincount would
        raise IndexError(
            f"key_ids out of range [0, {n_series}) for native sort_layout")
    seq_f = seq_i = None
    if seq is not None:
        dt = np.asarray(seq).dtype
        if np.issubdtype(dt, np.integer):
            # uint64 above 2^63 would wrap through int64: packing keeps
            # those on numpy
            seq_i = np.ascontiguousarray(np.asarray(seq).astype(np.int64))
        else:
            seq_f = np.ascontiguousarray(seq, dtype=np.float64)
    order = np.empty(n, dtype=np.int64)
    starts = np.empty(n_series + 1, dtype=np.int64)
    handle.tempo_sort_layout(
        _i64p(key_ids), _i64p(ts_ns), _f64p(seq_f), _i64p(seq_i),
        n, n_series, _i64p(order), _i64p(starts), threads())
    return order, starts


def take(values: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``values[order]`` along axis 0 (rows of an N-D array whole)."""
    handle = lib()
    values = np.ascontiguousarray(values)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if order.size and (int(order.min()) < 0
                       or int(order.max()) >= values.shape[0]):
        raise IndexError("order out of range for native take")
    row_bytes = values.dtype.itemsize * int(
        np.prod(values.shape[1:], dtype=np.int64))
    out = np.empty((order.shape[0],) + values.shape[1:], dtype=values.dtype)
    handle.tempo_take(_bytes_ptr(values), _i64p(order), order.shape[0],
                      row_bytes, _bytes_ptr(out), threads())
    return out


def pack(values_sorted: np.ndarray, starts: np.ndarray, padded_len: int,
         fill) -> np.ndarray:
    """A flat key-sorted column as dense ``[K, padded_len]`` rows, the
    tails ``fill``."""
    handle = lib()
    values_sorted = np.ascontiguousarray(values_sorted)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    K = starts.shape[0] - 1
    lengths = np.diff(starts)
    if lengths.size and (int(lengths.min()) < 0
                         or int(lengths.max()) > padded_len):
        # the numpy scatter faults on overflow rather than truncating
        raise IndexError(
            f"series lengths {int(lengths.min())}..{int(lengths.max())} "
            f"invalid for padded_len {padded_len}")
    if int(starts[-1]) > values_sorted.shape[0] or int(starts[0]) < 0:
        raise ValueError(
            f"starts[-1]={int(starts[-1])} exceeds values length "
            f"{values_sorted.shape[0]}")
    out = np.empty((K, padded_len), dtype=values_sorted.dtype)
    fill_elem = np.asarray(fill, dtype=values_sorted.dtype).tobytes()
    handle.tempo_pack(_bytes_ptr(values_sorted), _i64p(starts), K,
                      int(padded_len), values_sorted.dtype.itemsize,
                      ctypes.c_char_p(fill_elem), _bytes_ptr(out), threads())
    return out


def unpack(packed: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Dense ``[K, L]`` rows back to the flat key-sorted column."""
    handle = lib()
    packed = np.ascontiguousarray(packed)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    K = starts.shape[0] - 1
    lengths = np.diff(starts)
    if lengths.size and (int(lengths.min()) < 0
                         or int(lengths.max()) > packed.shape[1]):
        raise IndexError(
            "starts inconsistent with packed shape in native unpack")
    out = np.empty(int(starts[-1]), dtype=packed.dtype)
    handle.tempo_unpack(_bytes_ptr(packed), _i64p(starts), K,
                        packed.shape[1], packed.dtype.itemsize,
                        _bytes_ptr(out), threads())
    return out
