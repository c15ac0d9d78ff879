"""Preemption-safe training (counterpart of
``hcpdiff_tpu/trainer/preemption.py``).

A SIGTERM (and optionally SIGINT) sets a flag; the trainer's loop polls
``should_stop()``, saves its full state and returns, and the next run
continues from it through ``train.resume.auto``. Over several processes
the decision is collective: ``should_stop()`` is one MAX all-reduce of
this rank's flag, so every rank stops as soon as any rank was signalled,
and once agreed the flag latches. The trainer enters it every
``train.preemption_poll_step`` steps on every rank together (its step
counters agree), as the JAX trainer does.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from ..parallel import mesh as pm


class PreemptionGuard:
    """Installs signal handlers that request a cooperative stop.

    Use as a context manager around the train loop; the previous handlers
    come back on exit. Off the main thread (where Python allows no signal
    handler) it installs nothing and ``active`` is False. ``collective``:
    ``should_stop`` agrees over the process group.
    """

    def __init__(self, signals: Iterable[str] = ('SIGTERM',), collective: bool = False):
        self._names = [s for s in (signals or []) if hasattr(signal, s)]
        self.collective = collective
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
        """True on every rank as soon as any rank has received a stop
        signal; every rank must call it together when ``collective``."""
        local = self._flag.is_set()
        if not self.collective:
            return local
        flag = torch.tensor([int(local)], dtype=torch.int32, device=pm.comm_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed:
            # later queries on this rank keep returning True
            self._flag.set()
        return agreed


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
