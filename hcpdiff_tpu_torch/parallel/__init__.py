"""Multi-process training and tensor-parallel inference (counterpart of
``hcpdiff_tpu/parallel/``), on ``torch.distributed``."""
