"""The benchmark of the PyTorch port (hcpdiff_tpu_torch); see README.md."""
