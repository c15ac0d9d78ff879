"""Host milliseconds each training step call takes to return, with no
synchronise, over the observed part of a traced run."""
from hcpbench.readers import mean

LAYER = 'train step'
UNIT = 'ms'
MOVES = 'samples_per_s'


def read(obs):
    return mean(obs, 'step_host_ms')
