"""The UNet's ``ops/matmul.py`` GEMM entries' share of their roofline in
training cells: every call into ``geglu_dense`` (kernel B) and
``fused_dense`` (kernel C), forward counted by ``counts/gemm.py`` (2 M N K)
and backward by its ``*_backward`` (2 M N K for each of dX and dW that the
call needs), over the device time of the kernels launched inside those
calls and inside their backward (the plain fp32 products). Remat's
recompute of a forward is neither counted nor timed."""
from hcpbench.counts import gemm
from hcpbench.readers import roofline_share

LAYER = 'kernels'
UNIT = '%'
MOVES = 'samples_per_s'
TARGETS = [('hcpdiff_tpu_torch.models.unet', 'geglu_dense', 'ff_gemm', gemm.geglu,
            gemm.geglu_backward),
           ('hcpdiff_tpu_torch.models.unet', 'fused_dense', 'ff_gemm', gemm.dense,
            gemm.dense_backward)]


def read(obs):
    return roofline_share(obs, 'ff_gemm')
