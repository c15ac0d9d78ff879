"""CLI: python -m hcpdiff_tpu_torch.train --cfg cfgs/train/examples/X.yaml k=v
(the PyTorch port of ``python -m hcpdiff_tpu.train``)."""
from .trainer.trainer import main

if __name__ == '__main__':
    main()
