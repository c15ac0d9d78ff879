"""The reduction of a Chrome trace: busy time as the union of device
intervals, kernels attributed to the host range they were launched in, and
idle gaps named by the innermost range open when they began."""
from hcpbench.trace import WINDOW, reduce_trace, union


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur, 'tid': tid}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


def test_union():
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_reduce_trace():
    trace = {'traceEvents': [
        ev('user_annotation', WINDOW, 0, 1000),
        ev('user_annotation', 'hcpbench.unet', 10, 400),
        ev('user_annotation', 'hcpbench.attention', 20, 50),
        ev('cuda_runtime', 'cudaLaunchKernel', 25, 2, corr=1),      # inside attention
        ev('cuda_runtime', 'cudaLaunchKernel', 100, 2, corr=2),     # inside unet only
        ev('user_annotation', 'hcpbench.decode', 600, 300),
        ev('cuda_runtime', 'cudaLaunchKernel', 610, 2, corr=3),
        ev('kernel', 'flash', 30, 100, tid=7, corr=1),
        ev('kernel', 'gemm', 120, 100, tid=7, corr=2),              # overlaps the first
        ev('gpu_memcpy', 'copy', 700, 50, tid=8, corr=3),
        ev('kernel', 'outside', 2000, 10, tid=7, corr=4),           # after the window
    ]}
    r = reduce_trace(trace, ['hcpbench.attention', 'hcpbench.unet', 'hcpbench.decode'])
    assert r['window_s'] == 1000e-6
    assert abs(r['busy_s'] - (190 + 50) * 1e-6) < 1e-12
    assert abs(r['ranges']['hcpbench.attention']['device_s'] - 100e-6) < 1e-12
    assert abs(r['ranges']['hcpbench.unet']['device_s'] - 200e-6) < 1e-12
    assert abs(r['ranges']['hcpbench.decode']['device_s'] - 50e-6) < 1e-12
    assert r['device_ops'][0][0] in ('flash', 'gemm')
    gaps = dict((round(s * 1e6), name) for name, s in r['idle_gaps'])
    # 0-30 (window start, inside unet's span from 10? no: starts at 0), 220-700, 750-1000
    assert gaps[480] == 'hcpbench.unet'           # the gap at 220 began inside unet's span
    assert gaps[250] == 'hcpbench.decode'
    assert gaps[30] == WINDOW


def test_no_window_no_result():
    assert reduce_trace({'traceEvents': [ev('kernel', 'k', 0, 1)]}, []) is None


def test_backward_runs_in_the_entry_range(tmp_path):
    """A wrapped entry with a backward count: its forward and its backward
    each run inside one span of its range and are counted once; the forward
    that remat recomputes inside the backward is neither."""
    import json
    import sys
    import types
    from collections import defaultdict

    import torch
    from torch.utils.checkpoint import checkpoint

    from hcpbench.counts import gemm
    from hcpbench.entries import patched

    mod = types.ModuleType('hcpbench_test_entry')
    mod.f = lambda x, w: torch.nn.functional.linear(x, w).relu() * 2   # three nodes
    sys.modules[mod.__name__] = mod
    x0 = torch.randn(4, 8, requires_grad=True)
    w0 = torch.randn(6, 8, requires_grad=True)
    calls = defaultdict(list)
    target = (mod.__name__, 'f', 'e', gemm.dense, gemm.dense_backward)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(WINDOW), patched([target], calls):
                y = checkpoint(lambda x, w: mod.f(x, w).tanh(), x0 * 1, w0 * 1,
                               use_reentrant=False)
                y.sum().backward()
    finally:
        del sys.modules[mod.__name__]
    assert calls['e'] == [gemm.dense(x0, w0), gemm.dense_backward(x0 * 1, w0 * 1)]
    assert calls['e'][1][0] == 2 * 2 * 4 * 6 * 8
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())['traceEvents'] if e.get('ph') == 'X']
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events if e['name'] == 'hcpbench.e')
    assert len(spans) == 2
    (f0, f1), (b0, b1) = spans

    def inside(name, a, b):
        return [e for e in events if e['name'] == name and a <= e['ts'] <= b]
    assert inside('aten::linear', f0, f1) and not inside('ReluBackward0', f0, f1)
    for node in ('MulBackward0', 'ReluBackward0', 'MmBackward0'):
        assert inside(node, b0, b1), node
    # tanh is outside the entry; the recompute runs its linear outside both spans
    assert inside('TanhBackward0', f1, b0) and not inside('TanhBackward0', b0, b1)
    assert len(inside('aten::linear', f1, b0)) == 1
