"""The check against planted faults: a run of each tiny cell on the CPU
(the card check skipped) is correct as it stands, and not correct with each
fault of ``hcpbench/faults.py`` for its kind planted in the timed path."""
import pytest
import torch

from hcpbench.faults import FAULTS, planted
from hcpbench.tests.tiny import run


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('workload', ['tiny', 'tiny_xl', 'tiny_lora'])
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out['correct'], out['checks']
    assert out['failed'] == 0 and out['attempted'] >= 1


@pytest.mark.parametrize('workload,kind,fault',
                         [('tiny', 'txt2img', f) for f in FAULTS['txt2img']]
                         + [('tiny_lora', 'train', f) for f in FAULTS['train']])
def test_fault_is_not_correct(workload, kind, fault):
    with planted(kind, fault):
        out = run(workload)
    assert not out['correct'], out['checks']
    assert out['failed'] == 0
    over = [k for k, c in out['checks'].items() if not c['value'] <= c['limit']]
    assert over, out['checks']
