"""SLO classes of serving requests.

The part of ``mxnet_tpu/slo.py`` the engine's admission and preemption
need: the declared classes and the check of a request's class
(``:73``).  ``interactive`` is the default of a request that names none
and is admitted ahead of ``batch``; under page pressure ``batch`` streams
are preempted first.  The objectives, burn-rate tracker, canary probes
and per-request cost records are not ported yet (ROADMAP.md queue A
item 8, with the profiler).
"""

from __future__ import annotations

from .base import MXNetError

__all__ = ["SLO_CLASSES", "check_class"]

SLO_CLASSES = ("interactive", "batch")


def check_class(slo_class: str) -> str:
    """Validate a request's SLO class, naming the choices."""
    if slo_class not in SLO_CLASSES:
        raise MXNetError(
            f"unknown SLO class {slo_class!r}: expected one of "
            f"{SLO_CLASSES}")
    return slo_class
