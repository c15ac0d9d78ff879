"""The workflow engine's core (counterpart of ``hcpdiff_tpu/workflow/base.py``).

A workflow config is a list of actions run in order; each action maps a
``states`` dict to the next one, and ``MemoryMixin`` actions also read and
write the run's persistent ``memory`` dict (the models, the sampler).
``LoopAction`` runs its sub-actions once for each item of a states list
(the timesteps); ``ExecAction`` runs a Python program on ``states`` and
``memory``. ``${hcp.from_memory:a.b}`` in an action's config reads
``memory['a']['b']`` when the action is built.

An ``ExecAction`` program's absolute imports of the JAX package's or the
reference's paths (``from hcpdiff_tpu.data.processor import ...``) get the
port's objects (``config/instantiate.py:port_import``, ``locate``'s rule),
so a shipped program runs without JAX.
"""
from __future__ import annotations

import builtins
import re
from typing import Any, Dict, List, Optional

import torch

from ..config.instantiate import instantiate, port_import

_FROM_MEMORY = re.compile(r'^\$\{hcp\.from_memory:([^}]+)\}$')


def resolve_from_memory(value: Any, memory: Dict[str, Any]) -> Any:
    """``value`` with each ``${hcp.from_memory:a.b}`` string replaced by
    ``memory['a']['b']`` (an attribute where a level is not a dict),
    through dicts and lists."""
    if isinstance(value, str):
        m = _FROM_MEMORY.match(value.strip())
        if m:
            node: Any = memory
            for part in m.group(1).strip().split('.'):
                node = node[part] if isinstance(node, dict) else getattr(node, part)
            return node
    if isinstance(value, dict):
        return {k: resolve_from_memory(v, memory) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve_from_memory(v, memory) for v in value]
    return value


class BasicAction:
    def __init__(self, **kw):
        self.kw = kw

    def forward(self, **states) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, memory=None, **states) -> Dict[str, Any]:
        if isinstance(self, MemoryMixin):
            return self.forward(memory=memory, **states)
        return self.forward(**states)


class MemoryMixin:
    """Actions that read and write the persistent memory dict."""


class ExecAction(BasicAction):
    """Run a Python program with ``states`` and ``memory`` in its scope;
    returns its ``states`` (reference base.py:33)."""

    def __init__(self, prog: str, **kw):
        super().__init__(**kw)
        self.prog = prog

    def __call__(self, memory=None, **states):
        scope = {'states': states, 'memory': memory,
                 '__builtins__': dict(vars(builtins), __import__=port_import)}
        exec(self.prog, scope)
        return scope['states']


class LoopAction(BasicAction, MemoryMixin):
    """Run ``actions`` once for each item of the states lists that
    ``loop_value`` names ({states key: loop variable}), the item under the
    variable's name (reference base.py:41-59)."""

    def __init__(self, loop_value: Dict[str, str], actions: List[Any], **kw):
        super().__init__(**kw)
        self.loop_value = loop_value
        self.actions = actions

    def __call__(self, memory=None, **states):
        keys = list(self.loop_value)
        seqs = [states.pop(k) for k in keys]
        names = [self.loop_value[k] for k in keys]
        for values in zip(*seqs):
            states.update(zip(names, values))
            for act in self.actions:
                states = _run(act, memory, states)
        for name in names:
            states.pop(name, None)
        return states


def _run(act, memory, states):
    if isinstance(act, (MemoryMixin, ExecAction)):
        return act(memory=memory, **states)
    return act(**states)


class WorkflowRunner:
    """Runs a workflow config: its ``prepare`` actions, then its
    ``actions``, from empty states (reference hcpdiff/infer_workflow.py:12-57).
    ``memory`` starts as the config's ``memory`` and its top-level
    ``device`` (the card unless ``device: cpu``)."""

    def __init__(self, cfgs):
        self.cfgs = cfgs
        self.memory: Dict[str, Any] = dict(cfgs.get('memory') or {})
        if cfgs.get('device') is not None:
            self.memory.setdefault('device', str(cfgs.get('device')))

    def _build_actions(self, cfg_list) -> List[Any]:
        return [instantiate(resolve_from_memory(item, self.memory)) for item in (cfg_list or [])]

    # no_grad, not inference_mode: the models built here keep their version
    # counters, so the int8 route keeps its weight codes between UNet calls
    # (ops/int8.py:weight_codes quantizes an inference tensor at every call)
    @torch.no_grad()
    def run(self, actions: List[Any], states: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        states = dict(states or {})
        for act in actions:
            states = _run(act, self.memory, states)
        return states

    def start(self) -> Dict[str, Any]:
        states = self.run(self._build_actions(self.cfgs.get('prepare')), {})
        return self.run(self._build_actions(self.cfgs.get('actions')), states)
