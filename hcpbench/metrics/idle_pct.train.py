"""The device's idle share in training: 1 - the union of kernel, copy and
memset intervals a sample in the profiled steps over the host seconds a
sample in the unprofiled steps that follow them."""
from hcpbench.readers import idle_pct

LAYER = 'device'
UNIT = '%'
MOVES = 'samples_per_s'


def read(obs):
    return idle_pct(obs)
