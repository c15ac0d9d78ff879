"""CLI: python -m hcpdiff_tpu_torch.visualizer --cfg cfgs/infer/X.yaml k=v
(the PyTorch port of ``python -m hcpdiff_tpu.visualizer``)."""
from .infer.visualizer import main

if __name__ == '__main__':
    main()
