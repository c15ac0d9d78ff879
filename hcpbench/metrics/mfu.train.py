"""Model FLOP utilisation of training: three times the forward operations
of the UNet and the text encoder (``counts/model.py``) for each sample of
the steps completed in the observed part of a traced run, over its seconds
times the card's bf16 peak. Remat's recompute is not counted."""
from hcpbench.readers import mfu

LAYER = 'model'
UNIT = '%'
MOVES = 'samples_per_s'


def read(obs):
    return mfu(obs)
