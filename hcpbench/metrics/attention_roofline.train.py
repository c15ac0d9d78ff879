"""The attention entry's share of its roofline in training cells: every
call into ``ops/attention.py:attention`` from the UNet and the text encoder,
its forward counted by ``counts/attention.py:forward`` and its backward by
``counts/attention.py:backward`` (the four products), over the device time
of the kernels launched inside those calls and inside their backward (A
with lse, E and F, or the plain products of the 77-key attention). Remat's
recompute of a forward is neither counted nor timed."""
from hcpbench.counts import attention
from hcpbench.readers import roofline_share

LAYER = 'kernels'
UNIT = '%'
MOVES = 'samples_per_s'
TARGETS = [(f'hcpdiff_tpu_torch.models.{m}', 'attention', 'attention', attention.forward,
            attention.backward) for m in ('unet', 'clip')]


def read(obs):
    return roofline_share(obs, 'attention')
