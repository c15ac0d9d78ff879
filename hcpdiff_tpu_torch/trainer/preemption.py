"""Preemption-safe training (counterpart of
``hcpdiff_tpu/trainer/preemption.py``, single process).

A SIGTERM (and optionally SIGINT) sets a flag; the trainer's loop polls
``should_stop()`` once a step, saves its full state and returns, and the
next run continues from it through ``train.resume.auto``. The JAX
package's multi-host agreement (``process_allgather``) is not ported: the
trainer refuses ``multi_host`` (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional


class PreemptionGuard:
    """Installs signal handlers that request a cooperative stop.

    Use as a context manager around the train loop; the previous handlers
    come back on exit. Off the main thread (where Python allows no signal
    handler) it installs nothing and ``active`` is False.
    """

    def __init__(self, signals: Iterable[str] = ('SIGTERM',)):
        self._names = [s for s in (signals or []) if hasattr(signal, s)]
        self._flag = threading.Event()
        self._prev = {}
        self.active = False

    def __enter__(self) -> 'PreemptionGuard':
        try:
            for name in self._names:
                sig = getattr(signal, name)
                self._prev[sig] = signal.signal(sig, self._on_signal)
            self.active = bool(self._prev)
        except ValueError:
            self._prev = {}
            self.active = False
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}
        self.active = False
        return False

    def _on_signal(self, signum, frame):
        self._flag.set()

    def should_stop(self) -> bool:
        return self._flag.is_set()


def resolve_preemption_cfg(value) -> Optional[list]:
    """``train.preemption`` -> signal names or None: missing or True ->
    ['SIGTERM'], False -> None, a name or a list of names as given."""
    if value is None or value is True:
        return ['SIGTERM']
    if value is False:
        return None
    if isinstance(value, str):
        return [value]
    return [str(v) for v in value]
