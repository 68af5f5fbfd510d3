"""Persisted tuned-knob profiles: the autotuner's output.

Counterpart of ``tempo_tpu/tune/profile.py``.  A profile is one CRC'd
JSON document the sweep harness (:mod:`tempo_tpu_torch.tune.harness`)
writes: for each shape class the measured knob winners and their
rates, and the measured cost-model inputs (the card's own stream rate
in place of the prior in ``plan/cost.PRIORS``).  Its values are priors:

* a ``TEMPO_TPU_*`` knob set in the environment always wins over the
  profile (the readers in ``ops/stream.py``, ``ops/rolling.py``,
  ``serve/executor.py``, ``plan/optimizer.py`` and ``io/ingest.py``
  ask :func:`knob_value` only when their knob is unset);
* the cost model overlays ``measured`` between its priors and any
  :func:`tempo_tpu_torch.plan.cost.set_measured` call;
* :func:`stamp` folds the active profile's CRC into
  ``cost.fingerprint()`` (the executable cache's key) and into
  ``config.snapshot()`` (a captured graph's key): swapping profiles
  re-plans and re-captures, it never replays work built under the
  other profile's knobs.

**A foreign profile is refused by name.**  A profile is keyed by
``(device_kind, torch, cuda)``: the card's name, the torch build and
its CUDA version, any of which can move a crossover.  A profile whose
fingerprint differs from the running process's, or whose CRC does not
match its payload, is refused with a message naming the path and the
mismatch, and the built-in defaults stand.  A refused profile never
half-applies.

``TEMPO_TPU_TUNE_PROFILE`` names a profile path, or ``off`` loads
none; unset resolves to the checked-in profile of this device kind
under ``tempo_tpu_torch/tune/profiles/``.  No profile ships for the
CPU, so there the defaults stand.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import zlib
from typing import Dict, Optional

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1

#: knobs a profile may tune; anything else in a ``knobs`` section is
#: refused at load (a profile must never smuggle undeclared behaviour).
#: The reference's ``TEMPO_TPU_PACK_COLS``, ``TEMPO_TPU_JOIN_CHUNK_LANES``
#: and ``TEMPO_TPU_MEGACORE`` have no knob here, so a reference profile
#: naming one is refused by name
TUNABLE_KNOBS = (
    "TEMPO_TPU_DMA_BUFFERS",
    "TEMPO_TPU_STREAM_MAX_ROWS",
    "TEMPO_TPU_SERVE_BATCH_ROWS",
    "TEMPO_TPU_INGEST_RING",
    "TEMPO_TPU_STITCH_MAX_OPS",
    "TEMPO_TPU_SERVE_COALESCE_S",
)

#: the few tunable knobs whose values are (finite) floats, not ints —
#: everything else in a profile's ``knobs`` section must be an integer
FLOAT_KNOBS = ("TEMPO_TPU_SERVE_COALESCE_S",)


class TuneProfileError(ValueError):
    """A profile that cannot be applied, with the reason and the path
    in the message (corrupt payload, foreign fingerprint, undeclared
    knob).  The lazy loader downgrades this to a one-shot warning and
    falls back to defaults; ``load(strict=True)`` (the CLI, the tests)
    re-raises."""


#: the fingerprint's keys, each checked by name at load
FINGERPRINT_KEYS = ("device_kind", "torch", "cuda")


def runtime_fingerprint() -> Dict[str, str]:
    """What a profile is keyed by: the card the knobs were measured on
    (``torch.cuda.get_device_name``, or ``"cpu"`` without a card), the
    torch build and its CUDA version (either can move a crossover)."""
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(torch.cuda.current_device())
    else:
        kind = "cpu"
    return {
        "device_kind": str(kind),
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
    }


def _slug(device_kind: str) -> str:
    return re.sub(r"[^a-z0-9]+", "-", device_kind.lower()).strip("-")


def default_path(device_kind: Optional[str] = None) -> str:
    """The checked-in profile location for ``device_kind`` (default:
    the running process's device kind)."""
    if device_kind is None:
        device_kind = runtime_fingerprint()["device_kind"]
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "profiles", f"{_slug(device_kind)}.json")


def payload_crc(payload: dict) -> int:
    """CRC-32 of the canonical JSON rendering of ``payload`` (the
    profile document without its own ``crc`` field)."""
    body = {k: v for k, v in payload.items() if k != "crc"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode())


def write(payload: dict, path: str) -> str:
    """Persist a profile document atomically with its CRC stamped in.
    The payload must already carry ``format_version``/``fingerprint``;
    the harness is the only sanctioned producer."""
    payload = dict(payload)
    payload["crc"] = payload_crc(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate(payload: dict, path: str,
             fingerprint: Optional[Dict[str, str]] = None) -> dict:
    """CRC + fingerprint + schema checks; raises
    :class:`TuneProfileError` naming the path and the mismatch."""
    if not isinstance(payload, dict) or "crc" not in payload:
        raise TuneProfileError(
            f"tuned profile {path!r} refused: no CRC stamp "
            f"(not a harness-produced profile)")
    want = payload_crc(payload)
    if int(payload["crc"]) != want:
        raise TuneProfileError(
            f"tuned profile {path!r} refused: CRC mismatch "
            f"(stamped {payload['crc']}, payload {want}) — the file is "
            f"corrupt or hand-edited; re-run "
            f"`python -m tempo_tpu_torch.tune`")
    if payload.get("format_version") != FORMAT_VERSION:
        raise TuneProfileError(
            f"tuned profile {path!r} refused: format_version "
            f"{payload.get('format_version')!r} != {FORMAT_VERSION}")
    fp = fingerprint or runtime_fingerprint()
    got = payload.get("fingerprint") or {}
    for key in FINGERPRINT_KEYS:
        if got.get(key) != fp[key]:
            raise TuneProfileError(
                f"tuned profile {path!r} refused: foreign fingerprint — "
                f"profile {key}={got.get(key)!r}, this process "
                f"{key}={fp[key]!r}; profiles are measured artifacts "
                f"and never apply across {key}s (re-tune here)")
    for section in [payload.get("knobs") or {}] + [
            (c.get("knobs") or {}) for c in
            (payload.get("classes") or {}).values()
            if isinstance(c, dict)]:
        for name, value in section.items():
            if name not in TUNABLE_KNOBS:
                raise TuneProfileError(
                    f"tuned profile {path!r} refused: {name!r} is not a "
                    f"tunable knob ({', '.join(TUNABLE_KNOBS)})")
            # tunable knobs are integer-valued (FLOAT_KNOBS: finite
            # float): refuse malformed values HERE, by name, so a bad
            # profile never half-applies and then crashes inside a
            # knob reader mid-kernel-build
            if name in FLOAT_KNOBS:
                if isinstance(value, bool) \
                        or not isinstance(value, (int, float)) \
                        or not math.isfinite(value):
                    raise TuneProfileError(
                        f"tuned profile {path!r} refused: knob "
                        f"{name!r} has non-finite-float value "
                        f"{value!r} ({type(value).__name__})")
            elif isinstance(value, bool) or not isinstance(value, int):
                raise TuneProfileError(
                    f"tuned profile {path!r} refused: knob {name!r} has "
                    f"non-integer value {value!r} "
                    f"({type(value).__name__}) — tunable knobs are "
                    f"integers")
    from tempo_tpu_torch.plan import cost as plan_cost

    known = set(plan_cost.PRIORS)
    for name, value in (payload.get("measured") or {}).items():
        if name not in known:
            raise TuneProfileError(
                f"tuned profile {path!r} refused: measured input "
                f"{name!r} is not a cost-model input "
                f"({sorted(known)})")
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TuneProfileError(
                f"tuned profile {path!r} refused: measured input "
                f"{name!r} has non-numeric value {value!r} "
                f"({type(value).__name__})")
    return payload


# ----------------------------------------------------------------------
# lazy loader — memoized per TEMPO_TPU_TUNE_PROFILE value
# ----------------------------------------------------------------------

_lock = threading.Lock()
#: {"env": <knob string at load>, "profile": dict|None, "path": str|None}
_cache: Optional[dict] = None  # guarded-by: _lock


def _resolve():
    """(path, explicit) from ``TEMPO_TPU_TUNE_PROFILE``; (None, False)
    when loading is off or no checked-in profile exists."""
    from tempo_tpu_torch import config

    val = (config.get("TEMPO_TPU_TUNE_PROFILE") or "").strip()
    if val.lower() in ("off", "0", "none"):
        return None, False
    if val:
        return val, True
    path = default_path()
    return (path if os.path.exists(path) else None), False


def load(strict: bool = False):
    """The active profile document, or None (loading off, no profile
    for this device kind, or a refused profile).  Memoized per
    ``TEMPO_TPU_TUNE_PROFILE`` value — flipping the knob mid-process
    (a tuned-against-default flip, the tests) reloads on the next
    read; :func:`reload` drops the memo outright.  Refusals warn ONCE
    per memo generation and fall back to defaults; ``strict=True``
    re-raises them (the CLI and the lifecycle tests)."""
    global _cache
    from tempo_tpu_torch import config

    env_now = config.get("TEMPO_TPU_TUNE_PROFILE") or ""
    with _lock:
        if _cache is not None and _cache["env"] == env_now:
            if strict and _cache.get("error") is not None:
                raise TuneProfileError(_cache["error"])
            return _cache["profile"]
    profile, error, path = None, None, None
    try:
        path, explicit = _resolve()
        if path is not None:
            if not os.path.exists(path):
                raise TuneProfileError(
                    f"tuned profile {path!r} refused: file does not "
                    f"exist (TEMPO_TPU_TUNE_PROFILE points at it "
                    f"explicitly)" if explicit else
                    f"tuned profile {path!r} vanished")
            with open(path) as f:
                raw = json.load(f)
            profile = validate(raw, path)
    except (TuneProfileError, OSError, ValueError) as e:
        error = str(e)
        logger.warning("%s — falling back to built-in knob defaults",
                       error)
        profile = None
    with _lock:
        _cache = {"env": env_now, "profile": profile, "path": path,
                  "error": error}
    if strict and error is not None:
        raise TuneProfileError(error)
    return profile


def reload() -> None:
    """Drop the memoized profile (tests, in-process tuned-against-default
    flips)."""
    global _cache
    with _lock:
        _cache = None


def active_path() -> Optional[str]:
    """The path of the currently-loaded profile (None when none)."""
    with _lock:
        snap = _cache
    return snap["path"] if (snap and snap["profile"]) else None


def knob_value(name: str, shape_class: Optional[str] = None):
    """The tuned value for knob ``name`` — the *profile prior* the knob
    readers fall back to when their env knob is unset.  With
    ``shape_class`` the per-class winner is preferred over the merged
    knob set.  None when no profile is loaded or the profile does not
    tune this knob."""
    prof = load()
    if prof is None:
        return None
    if shape_class is not None:
        cls = (prof.get("classes") or {}).get(shape_class) or {}
        if name in (cls.get("knobs") or {}):
            return cls["knobs"][name]
    return (prof.get("knobs") or {}).get(name)


def resolve(name: str, default, shape_class: Optional[str] = None,
            cast=int):
    """What a knob reader reads: the knob set in the environment, else
    the profile's value (:func:`knob_value`), else ``default``."""
    from tempo_tpu_torch import config

    raw = (config.get(name) or "").strip()
    if raw:
        return cast(raw)
    tuned = knob_value(name, shape_class)
    return default if tuned is None else cast(tuned)


def measured() -> Dict[str, float]:
    """The profile's measured cost-model inputs (``{}`` when none):
    overlaid by ``plan/cost.params()`` between the hard-coded priors
    and any ``set_measured`` call."""
    prof = load()
    if prof is None:
        return {}
    return {k: float(v) for k, v in (prof.get("measured") or {}).items()}


def stamp() -> Optional[float]:
    """The active profile's CRC as a float (exact: CRC-32 < 2**53), or
    None when no profile is loaded — folded into ``cost.fingerprint()``
    / ``cost.params()`` so a profile swap re-plans instead of replaying
    executables built under the other profile's knobs."""
    prof = load()
    return None if prof is None else float(prof["crc"])
