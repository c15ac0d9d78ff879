"""The device's idle share in txt2img: 1 - the union of kernel, copy and
memset intervals an image in the profiled requests over the host seconds an
image in the unprofiled requests that follow them."""
from hcpbench.readers import idle_pct

LAYER = 'device'
UNIT = '%'
MOVES = 'images_per_s'


def read(obs):
    return idle_pct(obs)
