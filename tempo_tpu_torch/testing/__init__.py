"""Test support shipped with the port: fault injection
(:mod:`tempo_tpu_torch.testing.faults`) and the chaos campaign harness
(:mod:`tempo_tpu_torch.testing.chaos`: scripted kill / flaky / delay /
corrupt schedules against live serving, service, store and ingest
planes).

``chaos`` is imported lazily, on first access, since it pulls the serve
and service planes in; ``faults`` stays import-light."""

import importlib

from tempo_tpu_torch.testing import faults  # noqa: F401

__all__ = ["faults", "chaos"]


def __getattr__(name):
    if name == "chaos":
        return importlib.import_module("tempo_tpu_torch.testing.chaos")
    raise AttributeError(name)
