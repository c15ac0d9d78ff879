"""The controls. On the card, at each cell's own size on three seeds: the
program as configured passes every limit, its control fails at least one
(the SD1.5 txt2img cell's is the program's int8 route; the LoRA cell's is
the reference one precision below, fp8, in the program's place, since the
int8 route raises in training). Run with
``python -m pytest hcpbench/tests/test_hcpbench_control.py -m cuda``.
On the CPU: the lower-precision control of the tiny LoRA cell (fp32, so
bf16 below it) is not correct, and fp8 rounding is as coarse as its format."""
import json
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from hcpbench.harness import HERE, ROOT, Cell
from hcpbench.reference.lowp import LowerPrecision, rounded
from hcpbench.tests.tiny import BENCH, DATA


@pytest.mark.cuda
@pytest.mark.parametrize('cell,control', [('sd15-txt2img-b16', 'int8'),
                                          ('sd15-lora-b48', 'lowp')])
def test_control_fails_and_program_passes(tmp_path, cell, control):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the control runs the cell at its own size')
    out = tmp_path / 'controls.jsonl'
    subprocess.run([sys.executable, 'hcpbench/controls.py', '--workload', cell, '--seeds', '3',
                    '--first-seed', str(2 ** 31 + 101), '--variants', f'program,{control}',
                    '--out', str(out)], cwd=ROOT, check=True, timeout=900)
    limits = json.loads((HERE / 'limits' / f'{cell}.json').read_text())
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 6
    for r in rows:
        over = [k for k, v in r['checks'].items() if not v <= limits[k]]
        assert bool(over) == (r['variant'] == control), r


def test_lower_precision_control_is_not_correct_on_the_cpu():
    torch.set_num_threads(2)
    cell = Cell(BENCH, 'tiny_lora', ROOT, DATA)
    seed, cpu = 2 ** 31 + 11, torch.device('cpu')
    checks = cell.kind.check(cell.kind.control(cell.config, cell.traffic, seed, cpu),
                             cell.config, cell.traffic, seed, cpu, cell.limits)
    assert any(v > lim for _, v, lim in checks), checks


def test_fp8_rounding_and_restore():
    x = torch.linspace(-3, 3, 1001)
    e4m3 = rounded(x, torch.float8_e4m3fn)
    assert float(e4m3.abs().max()) == pytest.approx(3)      # scaled onto the format's range
    rel = ((e4m3 - x).abs() / x.abs().clamp(min=0.05)).max()
    assert 2 ** -5 < rel <= 2 ** -4                          # three mantissa bits
    linear = F.linear
    with LowerPrecision(torch.bfloat16):
        assert F.linear is not linear
        y = F.linear(x.abs().view(1, -1), torch.ones(1, 1001))
    assert F.linear is linear
    assert y.item() == pytest.approx(float(e4m3.abs().sum()), rel=1e-5)
