"""The harness finds configurations, traffic mixes, limits and metric
readers by name, refuses unknown ones, refuses to run without a card, and
prints a result line with the keys the contract names; BENCHMARK.json
agrees with the readers' declarations."""
import json
import re
import subprocess
import sys

import pytest

from hcpbench.harness import HERE, ROOT, Cell, load_json, load_module
from hcpbench.tests.tiny import BENCH, DATA, run

NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}')


@pytest.fixture(scope='module')
def bench():
    return load_json(ROOT / 'BENCHMARK.json')


def test_cells_find_their_files(bench):
    for w in bench['workloads']:
        cell = Cell(bench, w['name'])
        assert cell.kind.__name__.endswith(cell.traffic['kind'])
        assert set(cell.limits) == set(cell.kind.CHECKS)
        assert cell.readers().keys() == {m['name'] for m in cell.per_layer}
        assert any(m['name'] == 'setup_s' for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_unknown_names_are_refused(bench):
    with pytest.raises(LookupError):
        Cell(bench, 'no-such-cell')
    broken = json.loads(json.dumps(BENCH))
    broken['workloads'][0]['traffic'] = 'no-such-traffic'
    with pytest.raises(LookupError):
        Cell(broken, 'tiny', ROOT, DATA)
    with pytest.raises(LookupError):
        load_module(HERE / 'metrics' / 'no_such_metric.py')


def test_names_units_and_readers_agree(bench):
    configs = {c['name'] for c in bench['configs']}
    assert {w['config'] for w in bench['workloads']} == configs
    names = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert len(names) == len(set(names))
    for m in bench['end_to_end'] + bench['per_layer']:
        assert NAME.fullmatch(m['name']) and UNIT.fullmatch(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    moves = {m['name'] for m in bench['end_to_end']}
    for m in bench['per_layer']:
        reader = load_module(HERE / 'metrics' / f"{m['name']}.py")
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m['layer'], m['unit'], m['moves'])
        assert m['moves'] in moves
        e2e = next(e for e in bench['end_to_end'] if e['name'] == m['moves'])
        assert set(m['workloads']) <= set(e2e.get('workloads', m['workloads']))
    for w in bench['workloads']:
        assert NAME.fullmatch(w['name']) and NAME.fullmatch(w['traffic']) and w['chips'] == 1
        assert len(w['why']) <= 200


def test_result_line_keys():
    out = run('tiny_lora', trace=False)
    assert set(out['metrics']) == {'samples_per_s', 'setup_s'}
    assert set(out['checks']) == {'loss_rel', 'grad_gap', 'change_gap'}
    out = run('tiny', trace=True)
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics', 'device', 'checks']
    assert set(out['device']) == {'platform', 'kind', 'count', 'memory_peak_bytes'}
    assert set(out['checks']) == {'ctx_rel', 'attn1_rel', 'block0_rel', 'eps0_rel',
                                  'latent_rel', 'image_rmse'}
    assert all(set(c) == {'value', 'limit'} for c in out['checks'].values())
    # nothing ran on a device: the trace's readers find nothing, the host's do
    assert set(out['metrics']) <= {'host_ms_per_unet_call.txt2img', 'vae_decode_s.txt2img'}
    out = run('tiny', trace=False)
    assert set(out['metrics']) == {'images_per_s', 'request_s_p95', 'setup_s'}
    assert all(set(m) == {'value', 'unit'} for m in out['metrics'].values())


def command(*args):
    return subprocess.run([sys.executable, 'hcpbench/run.py', *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    proc = command('--workload', 'sd15-txt2img-b16', '--seed', str(2 ** 31 + 5), '--seconds',
                   '1', '--trace', '0')
    assert proc.returncode != 0 and proc.stdout == ''
    assert 'CUDA' in proc.stderr


def test_unknown_workload_no_result():
    proc = command('--workload', 'nope', '--seed', '1', '--seconds', '1', '--trace', '0')
    assert proc.returncode != 0 and proc.stdout == ''
