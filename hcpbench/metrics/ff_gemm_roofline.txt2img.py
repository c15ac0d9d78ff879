"""The feed-forward GEMMs' share of their roofline in txt2img cells: every
call into ``ops/matmul.py``'s ``geglu_dense`` (kernel B, ff.proj) and
``fused_dense`` (kernel C, ff.out) from the UNet, counted by
``counts/gemm.py`` (2 M N K), over the device time of the kernels launched
inside those calls."""
from hcpbench.counts import gemm
from hcpbench.readers import roofline_share

LAYER = 'kernels'
UNIT = '%'
MOVES = 'images_per_s'
TARGETS = [('hcpdiff_tpu_torch.models.unet', 'geglu_dense', 'ff_gemm', gemm.geglu),
           ('hcpdiff_tpu_torch.models.unet', 'fused_dense', 'ff_gemm', gemm.dense)]


def read(obs):
    return roofline_share(obs, 'ff_gemm')
