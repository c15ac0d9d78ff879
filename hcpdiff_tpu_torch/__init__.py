"""PyTorch/CUDA port of hcpdiff_tpu for NVIDIA Hopper (H100)."""
