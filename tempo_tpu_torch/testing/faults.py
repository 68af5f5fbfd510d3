"""Fault injection for the port's resilience paths.

Counterpart of ``tempo_tpu/testing/faults.py``.  Three fault families,
matching the :class:`~tempo_tpu_torch.resilience.FailureKind` they
exercise:

* **call-site faults**: :class:`FaultInjector` patches a callable on a
  module or object for the length of a ``with`` block and makes its
  first N calls fail (:meth:`FaultInjector.flaky`, transient-io), raises
  :class:`SimulatedKill` on the Nth call (:meth:`FaultInjector.
  kill_on_call`, a SIGKILL mid-save: it derives from ``BaseException``
  so the retry wrappers, which catch ``Exception``, never swallow it),
  or sleeps before the Nth call (:meth:`FaultInjector.delay_on_call`).
  The port's modules call their IO through module-level names
  (``checkpoint._savez``, ``store.engine._write_segment``,
  ``io.ingest._scan_fragment``, ...) and through ``np``, ``pd`` and
  ``os``, so patching those names here reaches the port;
* **artifact corruption**: :func:`corrupt_npz_array`, :func:`flip_byte`,
  :func:`truncate_file`, :func:`corrupt_parquet_row_group`,
  :func:`tear_parquet_footer`;
* **crash residue**: :func:`make_stale_tmp`, the ``<dir>.tmp`` a
  hard-killed save leaves behind.

Every injection is recorded on ``FaultInjector.records``, so a test can
assert that the fault fired.
"""

from __future__ import annotations

import dataclasses
import errno
import functools
import os
import shutil
import struct
import time
import zipfile
from typing import Callable, List, Optional

from tempo_tpu_torch.resilience import FailureKind


class SimulatedKill(BaseException):
    """Simulated SIGKILL: uncatchable by ``except Exception`` (and by
    the retry wrappers), exactly like the real thing.  Tests catch it
    explicitly at top level and then re-run the pipeline to exercise
    resume."""


class InjectedFault(OSError):
    """A synthetic transient IO failure (default ``EIO``) that
    self-describes its :class:`FailureKind` for ``classify``."""

    def __init__(self, message: str = "injected transient IO fault",
                 kind: FailureKind = FailureKind.TRANSIENT_IO):
        super().__init__(errno.EIO, message)
        self.failure_kind = kind


@dataclasses.dataclass
class InjectionRecord:
    target: str
    call_no: int
    action: str          # "raise" | "kill" | "delay" | "pass"


class FaultInjector:
    """Context manager that patches callables with faulty wrappers and
    restores them on exit (even on :class:`SimulatedKill`).

    Usage::

        with FaultInjector() as fi:
            fi.flaky(pd, "read_parquet", failures=2)
            fi.kill_on_call(np, "savez", call_no=2)
            ... run the pipeline ...
        assert [r.action for r in fi.records] == ["raise", "raise", ...]
    """

    def __init__(self):
        self.records: List[InjectionRecord] = []
        self._patches = []

    # ------------------------------------------------------------------
    def _patch(self, obj, attr: str, make_wrapper):
        original = getattr(obj, attr)
        self._patches.append((obj, attr, original))
        setattr(obj, attr, make_wrapper(original))
        return self

    @staticmethod
    def _name(obj, attr: str, label: Optional[str]) -> str:
        base = getattr(obj, "__name__", None) or type(obj).__name__
        return label or f"{base}.{attr}"

    def flaky(self, obj, attr: str, failures: int = 2,
              exc_factory: Optional[Callable[[int], BaseException]] = None,
              label: Optional[str] = None) -> "FaultInjector":
        """Make the first ``failures`` calls to ``obj.attr`` raise
        (default: :class:`InjectedFault`, a retryable transient-io
        error); later calls pass through to the original."""
        name = self._name(obj, attr, label)
        make_exc = exc_factory or (
            lambda n: InjectedFault(f"injected transient fault #{n} at {name}")
        )
        state = {"n": 0}

        def make_wrapper(original):
            @functools.wraps(original)
            def wrapper(*args, **kwargs):
                state["n"] += 1
                if state["n"] <= failures:
                    self.records.append(
                        InjectionRecord(name, state["n"], "raise"))
                    raise make_exc(state["n"])
                self.records.append(InjectionRecord(name, state["n"], "pass"))
                return original(*args, **kwargs)

            return wrapper

        return self._patch(obj, attr, make_wrapper)

    def kill_on_call(self, obj, attr: str, call_no: int = 1,
                     partial_write: Optional[Callable] = None,
                     label: Optional[str] = None) -> "FaultInjector":
        """Raise :class:`SimulatedKill` on the ``call_no``-th call to
        ``obj.attr`` (earlier and later calls pass through).

        ``partial_write(*args, **kwargs)``, when given, runs just before
        the kill to model bytes already flushed at the moment of death —
        e.g. writing a truncated file to the target path."""
        name = self._name(obj, attr, label)
        state = {"n": 0}

        def make_wrapper(original):
            @functools.wraps(original)
            def wrapper(*args, **kwargs):
                state["n"] += 1
                if state["n"] == call_no:
                    if partial_write is not None:
                        partial_write(*args, **kwargs)
                    self.records.append(
                        InjectionRecord(name, state["n"], "kill"))
                    raise SimulatedKill(
                        f"simulated kill at {name} call #{call_no}")
                self.records.append(InjectionRecord(name, state["n"], "pass"))
                return original(*args, **kwargs)

            return wrapper

        return self._patch(obj, attr, make_wrapper)

    def delay_on_call(self, obj, attr: str, seconds: float,
                      call_no: int = 1, n_calls: int = 1,
                      label: Optional[str] = None) -> "FaultInjector":
        """Latency injection: sleep ``seconds`` before calls
        ``call_no .. call_no + n_calls - 1`` to ``obj.attr``, then pass
        through (other calls are untouched).  The deterministic lever
        for the deadline plane: a delayed dispatch makes every tick
        queued behind it overstay a budget chosen below ``seconds``,
        so stage-named ``DeadlineExceeded`` paths are exercised without
        racing a wall clock."""
        name = self._name(obj, attr, label)
        state = {"n": 0}

        def make_wrapper(original):
            @functools.wraps(original)
            def wrapper(*args, **kwargs):
                state["n"] += 1
                if call_no <= state["n"] < call_no + n_calls:
                    self.records.append(
                        InjectionRecord(name, state["n"], "delay"))
                    time.sleep(seconds)
                else:
                    self.records.append(
                        InjectionRecord(name, state["n"], "pass"))
                return original(*args, **kwargs)

            return wrapper

        return self._patch(obj, attr, make_wrapper)

    def fail_always(self, obj, attr: str,
                    exc_factory: Optional[Callable[[int], BaseException]] = None,
                    label: Optional[str] = None) -> "FaultInjector":
        """Every call to ``obj.attr`` raises — for exercising retry
        exhaustion and deadline paths."""
        return self.flaky(obj, attr, failures=1 << 30,
                          exc_factory=exc_factory, label=label)

    # ------------------------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        for obj, attr, original in reversed(self._patches):
            setattr(obj, attr, original)
        self._patches.clear()
        return False


# ----------------------------------------------------------------------
# Artifact corruption
# ----------------------------------------------------------------------

def _npz_member_span(path: str, name: Optional[str] = None):
    """(member_name, data_offset, data_size) of one member of an npz
    archive — the largest by default (most likely a real data plane).
    Offsets come from the zip local header, so a flip lands inside the
    member's *stored* bytes, not container metadata."""
    with zipfile.ZipFile(path) as z:
        infos = [i for i in z.infolist() if i.file_size > 0]
        if name is not None:
            wanted = name if name.endswith(".npy") else name + ".npy"
            infos = [i for i in infos if i.filename == wanted]
        if not infos:
            raise ValueError(f"no matching member in {path!r}")
        info = max(infos, key=lambda i: i.file_size)
    with open(path, "rb") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
    data_off = info.header_offset + 30 + name_len + extra_len
    return info.filename, data_off, info.compress_size


def flip_byte(path: str, offset: int) -> None:
    """XOR one byte of ``path`` in place (the minimal corruption)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def corrupt_npz_array(path: str, name: Optional[str] = None) -> str:
    """Flip one byte in the middle of an npz member's stored data
    (``name`` or the largest member).  Returns the corrupted array's
    name (without the ``.npy`` suffix) so tests can assert the loader
    reports exactly that array."""
    member, off, size = _npz_member_span(path, name)
    # skip past the ~100-byte .npy header so the flip hits array bytes
    flip_byte(path, off + min(size - 1, 128 + (size - 128) // 2
                              if size > 256 else size // 2))
    return member[:-len(".npy")] if member.endswith(".npy") else member


def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Cut ``path`` down to ``keep_fraction`` of its size — the shape a
    buffered write killed mid-flush leaves behind.  Returns the new
    size."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_fraction))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def corrupt_parquet_row_group(path: str, row_group: int = 0,
                              column: int = 0) -> dict:
    """Corrupt ONE row group of a real Parquet file in place by
    smashing its first column chunk's page header (the minimal
    corruption a reader reliably detects: byte flips inside compressed
    page *data* can decode silently when page checksums are off, but a
    garbled page header always fails deserialization).  Sibling row
    groups stay readable — exactly the shape the ingest quarantine
    must isolate.  Returns ``{"file", "row_group", "rows", "offset"}``
    so tests can assert the quarantine names this precise range."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    rg = pf.metadata.row_group(row_group)
    col = rg.column(column)
    off = col.data_page_offset
    if col.dictionary_page_offset is not None:
        off = min(off, col.dictionary_page_offset)
    with open(path, "r+b") as f:
        f.seek(off)
        f.write(b"\xFF" * 8)
    return {"file": path, "row_group": row_group,
            "rows": rg.num_rows, "offset": off}


def tear_parquet_footer(path: str) -> int:
    """Torn-write injection: truncate a real Parquet file just short of
    its trailing footer magic, the state a hard kill mid-flush (or a
    partial object-store upload) leaves behind.  EVERY read of the file
    then fails at open ('magic bytes not found in footer'), so the
    whole file is the quarantine unit.  Returns the new size."""
    size = os.path.getsize(path)
    keep = max(0, size - 6)
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


# ----------------------------------------------------------------------
# Crash residue
# ----------------------------------------------------------------------

def make_stale_tmp(ckpt_path: str) -> str:
    """Fabricate the ``<ckpt_path>.tmp`` directory a hard-killed save
    leaves behind (partial manifest-less content).  Returns its path."""
    tmp = ckpt_path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(b"PK\x03\x04 partial write, killed mid-save")
    return tmp
