"""Seconds of ``AutoencoderKL.decode`` a request, between a synchronise
before and one after, over the observed part of a traced run."""
from hcpbench.readers import mean

LAYER = 'pipeline'
UNIT = 's'
MOVES = 'images_per_s'


def read(obs):
    return mean(obs, 'vae_decode_s')
