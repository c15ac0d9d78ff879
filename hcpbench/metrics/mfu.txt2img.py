"""Model FLOP utilisation of txt2img: the operations of the requests
completed in the observed part of a traced run (``counts/model.py``:
text encoders, every UNet call on the doubled batch, the VAE decode) over
its seconds times the card's bf16 peak."""
from hcpbench.readers import mfu

LAYER = 'model'
UNIT = '%'
MOVES = 'images_per_s'


def read(obs):
    return mfu(obs)
