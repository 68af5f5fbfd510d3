"""The persistent autotuner.

Counterpart of ``tempo_tpu/tune``.  ``python -m tempo_tpu_torch.tune``
sweeps the registered knob space (:mod:`tempo_tpu_torch.tune.space`) a
shape class at a time in child processes
(``python -m tempo_tpu_torch.tune.probe``), gates every candidate on a
bitwise audit of its outputs, and writes the winners as a CRC'd profile
(:mod:`tempo_tpu_torch.tune.profile`).  The names below are what the
knob readers consume at run time; a knob set in the environment always
wins, the profile is the prior under it, and the built-in default is
the floor:

* :func:`resolve` / :func:`knob_value`: tuned knob priors for the
  readers in
  ``ops/stream.py``, ``ops/rolling.py``, ``serve/executor.py``,
  ``plan/optimizer.py`` and ``io/ingest.py``;
* :func:`measured`: measured cost-model inputs, overlaid by
  ``plan/cost.params()`` under any ``cost.set_measured`` call;
* :func:`stamp`: the profile's CRC, folded into ``cost.fingerprint()``
  and ``config.snapshot()``, so a profile swap re-plans and re-captures.

Import-light: torch is asked for the card's name only when a profile is
resolved.
"""

from tempo_tpu_torch.tune.profile import (   # noqa: F401
    TUNABLE_KNOBS,
    TuneProfileError,
    active_path,
    default_path,
    knob_value,
    load,
    measured,
    reload,
    resolve,
    runtime_fingerprint,
    stamp,
)

__all__ = [
    "TUNABLE_KNOBS", "TuneProfileError", "active_path", "default_path",
    "knob_value", "load", "measured", "reload", "resolve",
    "runtime_fingerprint", "stamp",
]
