"""Host milliseconds each UNet call takes to return, with no synchronise,
over the observed part of a traced run: the dispatch cost, or the device's
pace once the launch queue is full."""
from hcpbench.readers import mean

LAYER = 'pipeline'
UNIT = 'ms'
MOVES = 'images_per_s'


def read(obs):
    return mean(obs, 'unet_host_ms')
