"""The attention entry's share of its roofline in txt2img cells: every call
into ``ops/attention.py:attention`` (UNet self- and cross-attention, the
VAE's mid-block attention, CLIP's causal attention), counted by
``counts/attention.py:forward``, over the device time of the kernels
launched inside those calls."""
from hcpbench.counts import attention
from hcpbench.readers import roofline_share

LAYER = 'kernels'
UNIT = '%'
MOVES = 'images_per_s'
TARGETS = [(f'hcpdiff_tpu_torch.models.{m}', 'attention', 'attention', attention.forward)
           for m in ('unet', 'vae', 'clip')]


def read(obs):
    return roofline_share(obs, 'attention')
