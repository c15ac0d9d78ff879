"""A tiny benchmark of three cells (SD1.5- and SDXL-shaped tiny configs'
txt2img and a LoRA step of the first, in fp32) that the CPU tests run the
harness on, with the card check skipped."""
from pathlib import Path

import torch

DATA = Path(__file__).resolve().parent / 'data'
ROOT = DATA.parents[2]
TXT2IMG = ['tiny', 'tiny_xl']
PER_LAYER = (('vae_decode_s.txt2img', 's', TXT2IMG),
             ('host_ms_per_unet_call.txt2img', 'ms', TXT2IMG),
             ('mfu.txt2img', '%', TXT2IMG), ('attention_roofline.txt2img', '%', TXT2IMG),
             ('ff_gemm_roofline.txt2img', '%', TXT2IMG), ('idle_pct.txt2img', '%', TXT2IMG),
             ('host_ms_per_step.train', 'ms', ['tiny_lora']), ('mfu.train', '%', ['tiny_lora']),
             ('attention_roofline.train', '%', ['tiny_lora']),
             ('ff_gemm_roofline.train', '%', ['tiny_lora']), ('idle_pct.train', '%', ['tiny_lora']))
BENCH = {
    'configs': [{'name': 'tiny', 'file': 'hcpbench/tests/data/tiny.json'},
                {'name': 'tiny_xl', 'file': 'hcpbench/tests/data/tiny_xl.json'}],
    'workloads': [{'name': 'tiny', 'config': 'tiny', 'traffic': 'tiny', 'chips': 1},
                  {'name': 'tiny_xl', 'config': 'tiny_xl', 'traffic': 'tiny', 'chips': 1},
                  {'name': 'tiny_lora', 'config': 'tiny', 'traffic': 'tiny_lora', 'chips': 1}],
    'end_to_end': [{'name': 'images_per_s', 'unit': 'images/s', 'workloads': TXT2IMG},
                   {'name': 'request_s_p95', 'unit': 's', 'workloads': TXT2IMG},
                   {'name': 'samples_per_s', 'unit': 'samples/s', 'workloads': ['tiny_lora']},
                   {'name': 'setup_s', 'unit': 's'}],
    'per_layer': [{'name': n, 'unit': u, 'workloads': w} for n, u, w in PER_LAYER],
}


def run(workload='tiny', trace=False, seconds=0.5, seed=2 ** 31 + 11):
    import time
    from hcpbench.harness import Cell, run_cell
    t0 = time.perf_counter()
    return run_cell(Cell(BENCH, workload, ROOT, DATA), seed, seconds, trace,
                    torch.device('cpu'), t0)
