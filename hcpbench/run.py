"""Run one cell of the benchmark of the PyTorch port and print its result
line:

    python3 hcpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``hcpbench/``
and ``hcpdiff_tpu_torch/``, on a machine with the card(s) the cell asks
for. Every build and kernel cache stays inside the checkout: the program's
nvcc library in ``hcpdiff_tpu_torch/_build/`` and the caches named below in
``.hcpbench_cache/``.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / '.hcpbench_cache'
CACHES = {'TRITON_CACHE_DIR': 'triton', 'TORCH_EXTENSIONS_DIR': 'torch_extensions',
          'CUDA_CACHE_PATH': 'cuda', 'TORCHINDUCTOR_CACHE_DIR': 'inductor'}

if __name__ == '__main__':
    # the checkout's root in place of this script's folder, whose module
    # names (trace, ...) would shadow the standard library's
    sys.path[0] = str(ROOT)
    for var, sub in CACHES.items():
        os.environ[var] = str(CACHE / sub)
    os.environ['USE_FLAX'] = '0'
    import torch
    torch.set_num_threads(4)
    from hcpbench.harness import main
    sys.exit(main(t0=T0))
