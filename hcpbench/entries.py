"""Wrappers around the program's entry points for the traced part of a
run. A per-layer metric names its entries in ``TARGETS``: tuples of (module,
attribute, entry name, count function) and, for an entry whose gradient is
taken, a fifth item, the count function of its backward. Each call of a
wrapped entry is counted at its shapes (``hcpbench/counts``) and run inside
the range ``hcpbench.<entry name>``, whose kernels the trace attributes to
it. With a backward count, a call whose output takes part in a gradient has
its backward counted too and run inside a range of the same name, opened on
the backward's thread when the first of the call's autograd nodes starts
and closed when the last has ended. A forward that remat recomputes inside
the backward is neither counted nor put in a range: recomputing is the
program's choice, not work the function needs.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

Target = Tuple  # (module, attribute, entry name, count[, backward count])

MAX_NODES = 64      # an entry's own autograd nodes; more means the walk left it


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def own_nodes(out: torch.Tensor, inputs: List[torch.Tensor]) -> Optional[list]:
    """The autograd nodes between ``out`` and the entry's inputs, or None
    where the walk finds more than MAX_NODES."""
    stops = {id(t.grad_fn) for t in inputs if t.grad_fn is not None}
    nodes, seen, todo = [], set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in stops or id(node) in seen \
                or type(node).__name__ == 'AccumulateGrad':
            continue
        seen.add(id(node))
        nodes.append(node)
        if len(nodes) > MAX_NODES:
            return None
        todo.extend(n for n, _ in node.next_functions)
    return nodes


def range_backward(nodes: list, name: str) -> None:
    """Open the range ``name`` when the first of ``nodes`` starts in the
    backward and close it when all have ended."""
    state = {'rf': None, 'left': len(nodes)}

    def pre(grad_outputs):
        if state['rf'] is None:
            state['rf'] = torch.profiler.record_function(name)
            state['rf'].__enter__()

    def post(grad_inputs, grad_outputs):
        state['left'] -= 1
        if state['left'] == 0 and state['rf'] is not None:
            state['rf'].__exit__(None, None, None)
    for node in nodes:
        node.register_prehook(pre)
        node.register_hook(post)


@contextlib.contextmanager
def patched(targets: List[Target], calls: Dict[str, list]) -> Iterator[None]:
    """Wrap the targets while the block runs; ``calls`` gathers {entry name:
    [(operations, bytes, dtype), ...]} of their calls (a ``defaultdict(list)``)."""
    saved = []
    try:
        for module_name, attr, entry, count, *backward in targets:
            module = importlib.import_module(module_name)
            orig = getattr(module, attr)
            if getattr(orig, '_hcpbench_entry', None):
                continue                # two metrics may name one entry

            def wrapped(*a, _orig=orig, _entry=entry, _count=count,
                        _bwd: Optional[Callable] = (backward or [None])[0], **k):
                if _in_backward():
                    return _orig(*a, **k)
                calls[_entry].append(_count(*a, **k))
                with torch.profiler.record_function('hcpbench.' + _entry):
                    out = _orig(*a, **k)
                if _bwd is not None and out.requires_grad:
                    inputs = [t for t in (*a, *k.values())
                              if torch.is_tensor(t) and t.requires_grad]
                    nodes = own_nodes(out, inputs)
                    if nodes:
                        calls[_entry].append(_bwd(*a, **k))
                        range_backward(nodes, 'hcpbench.' + _entry)
                return out
            wrapped._hcpbench_entry = entry
            setattr(module, attr, wrapped)
            saved.append((module, attr, orig))
        yield
    finally:
        for module, attr, orig in reversed(saved):
            setattr(module, attr, orig)
