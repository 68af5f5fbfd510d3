"""Failure classification, retry and backoff, deadlines, circuit breakers
and resumable pipelines.

Counterpart of ``tempo_tpu/resilience.py`` (host-only code):

* **Failure taxonomy**: :class:`FailureKind` and :func:`classify` map an
  exception to the recovery it admits.  A flaky read (transient-io) is
  retried; a checksum mismatch (corrupted-artifact) is not, an older
  checkpoint is the recovery; an out-of-memory needs a smaller program.
* **Bounded retry**: :class:`RetryPolicy` (exponential backoff, jitter,
  an attempt cap and a wall-clock deadline) and :func:`retrying`, the
  wrapper that checkpoint IO (``checkpoint.py``) and Parquet ingest
  (``io/ingest.py``) ride.
* **Resumable pipelines**: :func:`run_resumable` chains frame ops with
  checkpoints after steps and, on restart, resumes from the newest
  intact checkpoint of the same pipeline, re-running only the steps
  after it.
* **Fault-domain primitives**: :class:`Deadline` (one wall-clock budget
  checked by stage name), :class:`Cancelled` / :class:`ShutdownError`
  and :class:`CircuitBreaker` / :class:`QuarantinedError` (per-key
  quarantine with half-open probes).

``testing/faults.py`` injects the faults these paths handle.
``max_merged_lanes`` lives in ``profiling.py`` and is re-exported here.
"""

from __future__ import annotations

import dataclasses
import enum
import errno
import functools
import hashlib
import logging
import os
import random
import re
import threading
import time
import zipfile
from typing import Callable, FrozenSet, Optional, Sequence

import numpy as np

from tempo_tpu_torch import config
from tempo_tpu_torch.profiling import (  # noqa: F401  (re-exported)
    DEFAULT_MAX_MERGED_LANES, max_merged_lanes,
)

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# Failure taxonomy
# ----------------------------------------------------------------------

class FailureKind(enum.Enum):
    """What an exception means for recovery, whichever library raised
    it."""

    TRANSIENT_IO = "transient-io"            # retry with backoff
    CORRUPTED_ARTIFACT = "corrupted-artifact"  # fall back to older data
    COMPILE_OOM = "compile-oom"              # shrink the program
    DEVICE_LOSS = "device-loss"              # re-init runtime / new mesh
    DEADLINE = "deadline"                    # give up, surface diagnostics
    PERMANENT = "permanent"                  # a bug or bad input: raise


class CheckpointError(ValueError):
    """A checkpoint could not be used: missing, corrupt (checksum or
    container failure), or written by a newer format version.  Carries
    its :class:`FailureKind`, so retry wrappers do not retry corruption
    (an older checkpoint is the recovery, not a re-read)."""

    def __init__(self, message: str,
                 kind: FailureKind = FailureKind.CORRUPTED_ARTIFACT):
        super().__init__(message)
        self.failure_kind = kind


class DeadlineExceeded(TimeoutError):
    """A wall-clock budget ran out: a retry loop past
    ``RetryPolicy.deadline_s``, or a :class:`Deadline` at a named stage
    (``stage``)."""

    failure_kind = FailureKind.DEADLINE

    def __init__(self, message: str, stage: Optional[str] = None):
        super().__init__(message)
        self.stage = stage


class Cancelled(RuntimeError):
    """A ticket was cancelled before a worker processed it.  Deliberate,
    never retried."""

    failure_kind = FailureKind.PERMANENT


class ShutdownError(RuntimeError):
    """The plane shut down, or died, with this ticket outstanding: every
    pending ticket fails with this named error instead of hanging its
    caller."""

    failure_kind = FailureKind.PERMANENT


class QuarantinedError(RuntimeError):
    """Work refused because its circuit breaker is open: the same key
    failed ``TEMPO_TPU_BREAKER_THRESHOLD`` consecutive times and stays
    quarantined until a half-open probe (one admission after
    ``TEMPO_TPU_BREAKER_COOLDOWN_S``) succeeds."""

    failure_kind = FailureKind.PERMANENT

    def __init__(self, message: str, key=None,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.key = key
        self.retry_after_s = retry_after_s


# ----------------------------------------------------------------------
# End-to-end deadlines
# ----------------------------------------------------------------------

class Deadline:
    """A wall-clock budget checked by name at every stage it crosses, so
    the caller learns where it ran out.  Monotonic-clock based; no
    budget is the absence of a Deadline (``Deadline.after(None) is
    None``)."""

    __slots__ = ("budget_s", "expires_at", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self.expires_at = clock() + self.budget_s

    @classmethod
    def after(cls, budget_s, clock: Callable[[], float] = time.monotonic
              ) -> "Optional[Deadline]":
        """``None`` or non-positive: no deadline; a :class:`Deadline`
        passes through unchanged."""
        if budget_s is None:
            return None
        if isinstance(budget_s, Deadline):
            return budget_s
        if budget_s <= 0:
            return None
        return cls(budget_s, clock=clock)

    def remaining(self) -> float:
        return self.expires_at - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self.expires_at

    def check(self, stage: str) -> None:
        """Raise :class:`DeadlineExceeded` naming ``stage`` when the
        budget is gone."""
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExceeded(
                f"deadline exceeded at stage {stage!r}: the "
                f"{self.budget_s:.3f}s budget ran out "
                f"{-rem:.3f}s ago", stage=stage)

    def __repr__(self) -> str:
        return (f"Deadline(budget_s={self.budget_s:.3f}, "
                f"remaining={self.remaining():.3f})")


# ----------------------------------------------------------------------
# Circuit breaker (per-key quarantine with half-open probes)
# ----------------------------------------------------------------------

class CircuitBreaker:
    """Per-key failure quarantine.  ``threshold`` consecutive failures
    open the circuit of a key: :meth:`allow` then raises
    :class:`QuarantinedError` at once.  After ``cooldown_s`` the circuit
    is half-open: one probe is admitted; its success closes the circuit,
    its failure re-opens it for another cooldown.  Thread-safe."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if threshold is None:
            threshold = config.get_int("TEMPO_TPU_BREAKER_THRESHOLD", 3)
        if cooldown_s is None:
            cooldown_s = config.get_float("TEMPO_TPU_BREAKER_COOLDOWN_S",
                                          5.0)
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        # key -> [consecutive_failures, opened_at | None, probing]
        self._st = {}  # guarded-by: self._lock
        self.quarantined_total = 0  # guarded-by: self._lock
        self.trips = 0  # guarded-by: self._lock

    def state(self, key) -> str:
        """``"closed"``, ``"open"`` or ``"half-open"`` for ``key``."""
        with self._lock:
            st = self._st.get(key)
            if st is None or st[1] is None:
                return "closed"
            if st[2] or self._clock() - st[1] >= self.cooldown_s:
                return "half-open"
            return "open"

    def allow(self, key, label: str = "work") -> None:
        """Admit or refuse ``key``: raises :class:`QuarantinedError`
        while the circuit is open (or its half-open probe is in flight);
        admits the one probe once the cooldown has elapsed."""
        with self._lock:
            st = self._st.get(key)
            if st is None or st[1] is None:
                return
            elapsed = self._clock() - st[1]
            if not st[2] and elapsed >= self.cooldown_s:
                st[2] = True        # this caller is the half-open probe
                return
            self.quarantined_total += 1
            wait = max(0.0, self.cooldown_s - elapsed)
            raise QuarantinedError(
                f"{label} {key!r} is quarantined: {st[0]} consecutive "
                f"failures opened its circuit breaker"
                + ("; half-open probe already in flight" if st[2]
                   else f"; next half-open probe in {wait:.2f}s"),
                key=key, retry_after_s=wait)

    def record(self, key, ok: bool) -> None:
        """Record one outcome for ``key``: success closes the circuit
        and resets its counters; failure counts toward the threshold or
        re-opens a probing circuit."""
        with self._lock:
            st = self._st.setdefault(key, [0, None, False])
            if ok:
                if st[0] or st[1] is not None:
                    self._st[key] = [0, None, False]
                return
            st[0] += 1
            if st[1] is not None or st[0] >= self.threshold:
                if st[1] is None:
                    self.trips += 1
                st[1] = self._clock()   # (re)open; probe slot resets
                st[2] = False

    def abandon(self, key) -> None:
        """The in-flight half-open probe of ``key`` will never report:
        free its slot so the next :meth:`allow` can probe again."""
        with self._lock:
            st = self._st.get(key)
            if st is not None and st[1] is not None and st[2]:
                st[2] = False

    def stats(self) -> dict:
        with self._lock:
            open_keys = [k for k, st in self._st.items()
                         if st[1] is not None]
            return {"open": sorted(map(str, open_keys)),
                    "trips": self.trips,
                    "quarantined_total": self.quarantined_total}


# errnos of a transient environment problem, not a bug
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "EAGAIN", "EINTR", "EBUSY", "ETIMEDOUT", "ECONNRESET",
        "ECONNABORTED", "ECONNREFUSED", "ENETRESET", "ENETUNREACH",
        "EHOSTUNREACH", "EPIPE", "EIO", "ESTALE",
    )
    if hasattr(errno, name)
)

# message patterns of errors that arrive as bare RuntimeError strings
_OOM_PAT = re.compile(
    r"resource[ _]exhausted|out of memory|\boom\b|cannot allocate memory"
    r"|allocation .* (failed|exceeds)|exceeds the limit in memory",
    re.IGNORECASE,
)
_DEVICE_PAT = re.compile(
    r"device (?:lost|halted|failure|unavailable)|DEVICE_LOST"
    r"|data[ _]loss|chip (?:reboot|halt)|\bnccl\b|ici (?:link|failure)",
    re.IGNORECASE,
)
_DEADLINE_PAT = re.compile(
    r"deadline[ _]exceeded|timed[ _]?out|timeout", re.IGNORECASE
)
_TRANSIENT_PAT = re.compile(
    r"\bunavailable\b|connection (?:reset|refused|aborted)"
    r"|temporarily|try again|broken pipe",
    re.IGNORECASE,
)


def classify(exc: BaseException) -> FailureKind:
    """Map an exception to its :class:`FailureKind`.

    Precedence: an explicit ``failure_kind`` attribute wins; then typed
    checks (OSError errno, TimeoutError, zip/EOF container failures);
    then message patterns; then ``PERMANENT`` (unknown failures must
    surface, not retry)."""
    kind = getattr(exc, "failure_kind", None)
    if isinstance(kind, FailureKind):
        return kind
    # errno before the TimeoutError check: OSError(ETIMEDOUT) arrives as
    # a TimeoutError, and a socket timeout is transient (retry), unlike
    # a logical deadline (give up)
    if isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS:
        return FailureKind.TRANSIENT_IO
    if isinstance(exc, TimeoutError):
        return FailureKind.DEADLINE
    if isinstance(exc, (zipfile.BadZipFile, EOFError)):
        return FailureKind.CORRUPTED_ARTIFACT
    if isinstance(exc, MemoryError):
        return FailureKind.COMPILE_OOM
    if isinstance(exc, ConnectionError):
        return FailureKind.TRANSIENT_IO
    if isinstance(exc, OSError) and exc.errno == errno.ENOENT:
        return FailureKind.PERMANENT
    msg = str(exc)
    if _OOM_PAT.search(msg):
        return FailureKind.COMPILE_OOM
    if _DEVICE_PAT.search(msg):
        return FailureKind.DEVICE_LOSS
    if _DEADLINE_PAT.search(msg):
        return FailureKind.DEADLINE
    if _TRANSIENT_PAT.search(msg):
        return FailureKind.TRANSIENT_IO
    return FailureKind.PERMANENT


# ----------------------------------------------------------------------
# Retry / backoff
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter and a wall-clock deadline.

    ``retry_on`` is the set of :class:`FailureKind` worth another
    attempt; anything else re-raises at once.  ``deadline_s`` caps the
    total time of the retry loop: it never starts a sleep that would
    cross it."""

    max_attempts: int = 4
    base_delay_s: float = 0.1
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.5            # fraction of each delay randomized away
    deadline_s: Optional[float] = None
    retry_on: FrozenSet[FailureKind] = frozenset({FailureKind.TRANSIENT_IO})

    def delay_s(self, prior_failures: int, rng: random.Random) -> float:
        raw = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** prior_failures)
        return raw * (1.0 - self.jitter * rng.random())


#: Default policy for host file IO (checkpoints and Parquet ingest).
DEFAULT_IO_POLICY = RetryPolicy(
    max_attempts=4, base_delay_s=0.05, max_delay_s=2.0, deadline_s=60.0,
)


def retrying(
    policy: Optional[RetryPolicy] = None,
    label: Optional[str] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
):
    """Decorator giving a callable bounded retry.

    Catches ``Exception`` only: a simulated kill
    (``testing.faults.SimulatedKill``) and real signals derive from
    ``BaseException`` and always propagate.  Each retry logs a warning
    with the classified kind; exhaustion re-raises the last failure, or
    raises :class:`DeadlineExceeded` when the wall clock ran out."""
    pol = policy or DEFAULT_IO_POLICY
    _rng = rng or random.Random()

    def deco(fn):
        name = label or getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            start = clock()
            failures = 0
            while True:
                try:
                    return fn(*args, **kwargs)
                except Exception as exc:
                    kind = classify(exc)
                    failures += 1
                    if kind not in pol.retry_on:
                        raise
                    if failures >= pol.max_attempts:
                        logger.error(
                            "%s: giving up after %d attempt(s) (%s: %s)",
                            name, failures, kind.value, exc,
                        )
                        raise
                    delay = pol.delay_s(failures - 1, _rng)
                    elapsed = clock() - start
                    if pol.deadline_s is not None and \
                            elapsed + delay > pol.deadline_s:
                        logger.error(
                            "%s: retry deadline %.1fs exhausted after %d "
                            "attempt(s) (%s: %s)",
                            name, pol.deadline_s, failures, kind.value, exc,
                        )
                        raise DeadlineExceeded(
                            f"{name}: {elapsed:.1f}s elapsed of "
                            f"{pol.deadline_s:.1f}s retry deadline "
                            f"(last failure: {exc})"
                        ) from exc
                    logger.warning(
                        "%s: attempt %d/%d failed (%s: %s); retrying in "
                        "%.2fs", name, failures, pol.max_attempts,
                        kind.value, exc, delay,
                    )
                    sleep(delay)

        return wrapper

    return deco


def call_with_retry(fn, *args, policy: Optional[RetryPolicy] = None,
                    label: Optional[str] = None, **kwargs):
    """One-shot form of :func:`retrying`."""
    return retrying(policy, label=label)(fn)(*args, **kwargs)


# ----------------------------------------------------------------------
# Resumable pipelines
# ----------------------------------------------------------------------

def _apply_step(state, step):
    """A step is a callable ``frame -> frame``, a method name, or a
    ``(method_name, kwargs)`` tuple."""
    if callable(step):
        return step(state)
    if isinstance(step, str):
        return getattr(state, step)()
    name = step[0]
    kwargs = step[1] if len(step) > 1 else {}
    return getattr(state, name)(**kwargs)


def _step_label(step) -> str:
    if callable(step):
        return getattr(step, "__name__", repr(step))
    if isinstance(step, str):
        return step
    return str(step[0])


def _sig_canon(value) -> str:
    """Process-stable canonical string of one step kwarg: scalars by
    value (numpy scalars unwrapped), containers recursively, anything
    else by type only (a ``repr`` with a memory address would make a
    restarted process refuse its own checkpoints)."""
    if isinstance(value, np.generic) and value.shape == ():
        value = value.item()
    if value is None or isinstance(value, (bool, int, float, str)):
        return repr(value)
    if isinstance(value, (list, tuple)):
        return "[" + ",".join(_sig_canon(v) for v in value) + "]"
    if isinstance(value, dict):
        items = sorted(value.items(), key=lambda kv: str(kv[0]))
        return "{" + ",".join(f"{k}:{_sig_canon(v)}" for k, v in items) + "}"
    return f"<{type(value).__name__}>"


def pipeline_signature(steps: Sequence) -> str:
    """Stable signature of a :func:`run_resumable` step chain, stamped
    into every step manifest so a resume refuses a foreign pipeline's
    state by name: the step count, method names and canonical kwargs;
    callables count by position only."""
    parts = []
    for step in steps:
        if callable(step):
            parts.append("<callable>")
        elif isinstance(step, str):
            parts.append(f"method:{step}")
        else:
            kwargs = step[1] if len(step) > 1 else {}
            parts.append(f"method:{step[0]}:{_sig_canon(dict(kwargs))}")
    h = hashlib.sha1(repr((len(parts), parts)).encode())
    return h.hexdigest()[:16]


def resume_signature(frame, steps: Sequence) -> str:
    """The signature :func:`run_resumable` stamps by default: the step
    chain plus the input frame's content fingerprint
    (``store.engine.source_fingerprint``), so the same chain over new
    data never restores the previous data's checkpoints."""
    from tempo_tpu_torch.store.engine import source_fingerprint

    return hashlib.sha1(
        f"{pipeline_signature(steps)}|{source_fingerprint(frame)}".encode()
    ).hexdigest()[:16]


def run_resumable(
    frame,
    steps: Sequence,
    ckpt_dir: str,
    every: int = 1,
    keep_last: int = 2,
    sharded: bool = False,
    signature: Optional[str] = None,
):
    """Run a chain of frame ops with checkpoints and crash-resume.

    ``steps`` is a sequence of callables ``frame -> frame``, method
    names or ``(method_name, kwargs)`` tuples.  After every ``every``-th
    step, and after the last, the frame is checkpointed to
    ``ckpt_dir/step_NNNNN`` with :func:`checkpoint.save` (atomic,
    checksummed), its manifest stamped with the pipeline signature
    (:func:`resume_signature`, or ``signature``) and the CRC-32 of the
    previous step's manifest; checkpoints beyond ``keep_last`` are
    pruned.

    On restart with the same ``ckpt_dir`` the newest intact,
    chain-consistent checkpoint stamped by this pipeline is restored
    and only the steps after it run (:func:`checkpoint.resolve_step`);
    corrupt candidates fall back to older ones, and a checkpoint
    stamped by another pipeline raises :class:`CheckpointError`.  The
    port's ops are deterministic, so a resumed result equals an
    uninterrupted one bitwise."""
    from tempo_tpu_torch import checkpoint

    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    os.makedirs(ckpt_dir, exist_ok=True)
    sig = signature or resume_signature(frame, steps)
    mesh = getattr(frame, "mesh", None)
    series_axis = getattr(frame, "series_axis", "series")
    time_axis = getattr(frame, "time_axis", None)
    device = getattr(frame, "device", None)     # host frames

    state, done = frame, 0
    prev = None          # (step, manifest CRC) of the chain predecessor
    below = None
    while True:
        # resolve on manifests alone; load verifies the arrays once and
        # an unloadable candidate falls back to the next older one
        hit = checkpoint.resolve_step(ckpt_dir, signature=sig,
                                      max_step=len(steps), verify=False,
                                      below_step=below)
        if hit is None:
            break
        step_no, path, _man = hit
        try:
            state = checkpoint.load(path, mesh=mesh,
                                    series_axis=series_axis,
                                    time_axis=time_axis, device=device)
        except (CheckpointError, ValueError) as e:
            logger.warning(
                "run_resumable: checkpoint %s unusable (%s); falling "
                "back to an older one", path, e)
            state, below = frame, step_no
            continue
        done = step_no
        prev = (step_no, checkpoint.manifest_crc(path))
        logger.info("run_resumable: resumed after step %d/%d from %s",
                    done, len(steps), path)
        break

    for i in range(done, len(steps)):
        state = _apply_step(state, steps[i])
        if (i + 1) % every == 0 or i + 1 == len(steps):
            path = os.path.join(ckpt_dir, f"step_{i + 1:05d}")
            meta = {"pipeline_signature": sig, "step": i + 1,
                    "step_label": _step_label(steps[i])}
            if prev is not None:
                meta["prev_step"], meta["prev_manifest_crc"] = prev
            checkpoint.save(state, path, sharded=sharded, meta=meta)
            prev = (i + 1, checkpoint.manifest_crc(path))
            logger.info("run_resumable: step %d/%d (%s) checkpointed to %s",
                        i + 1, len(steps), _step_label(steps[i]), path)
            checkpoint.prune(ckpt_dir, keep_last=keep_last)
    return state
