"""The port's kernels (``csrc/``) and their wrappers; each wrapper counts
its own launches (``<wrapper>.launches``)."""


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count, by the wrapper's name."""
    from . import flash_attention as fa
    from . import matmul as mm
    from .conv import conv3x3
    from .groupnorm import group_norm_silu
    from .int8 import int8_dense, int8_geglu_dense, quantize_rows
    fns = (fa.flash_attention, fa.flash_attention_lse, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv, mm.geglu_dense, mm.fused_dense, group_norm_silu,
           mm.ln_qkv, mm.ln_geglu, mm.ln_dense, conv3x3, quantize_rows, int8_dense,
           int8_geglu_dense)
    return {fn.__name__: fn.launches for fn in fns}
