"""Kernels E and F against their plain versions at every shape chip_smoke.py
and the card tests run them at, for one checkout: the relative L2 error and
the largest absolute error of dq, dk and dv, to anchor a bound on the
accepted kernels before a redesign is held to it.

    python hcpdiff_tpu_torch/tools/bwd_errors.py [--tree DIR] > result.json

Imports ``hcpdiff_tpu_torch`` from the checkout rooted at ``--tree`` (by
default this one). Shapes: chip_smoke.py's training shapes, its classic and
VAE shapes causal and not, its head-dim phase (D 16, 96, 144 causal, 192
causal) and its fp32 case, then ``test_flash_backward_every_plan``'s (every
padded head dim at S 1000 and 4000, causal and not, head-split views).
Inputs are N(0, 1) bf16 (fp32 for the fp32 case, held against the plain
version on the operands rounded to bf16). Prints one JSON object with the
card's name and power limit, each case's errors, and the worst relative L2
error. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

TRAIN = [((8, 8, 4096, 40), False), ((8, 8, 1024, 80), False)]
CLASSIC = [(s, c) for s in ((2, 10, 4096, 64), (2, 8, 4096, 128), (8, 8, 1024, 160),
                            (2, 1, 4096, 512)) for c in (False, True)]
HEAD_DIMS = [((2, 8, 1024, 16), False), ((2, 8, 1024, 96), False), ((2, 8, 1024, 144), True),
             ((2, 8, 1024, 192), True)]
PADDED = (48, 64, 80, 128, 160, 512)
EVERY_PLAN = [((1, 2, S, D), c) for D in PADDED for S in (1000, 4000) for c in (False, True)]


def _errors(out, ref):
    out, ref = out.float(), ref.float()
    return {'rel_l2': float((out - ref).norm() / ref.norm()),
            'max_abs': float((out - ref).abs().max()),
            'max_ref': float(ref.abs().max())}


def _case(fa, gen, shape, causal, fp32=False, views=False):
    B, H, S, D = shape
    dt = torch.float32 if fp32 else torch.bfloat16

    def rn():
        if views:
            return torch.randn(B, S, H * D, device='cuda', generator=gen).to(dt).view(
                B, S, H, D).transpose(1, 2)
        return torch.randn(*shape, device='cuda', generator=gen).to(dt)

    q, k, v, do = rn(), rn(), rn(), rn()
    sc = D ** -0.5
    o, lse = fa.flash_attention_lse(q, k, v, sc, causal)
    delta = fa.attention_delta(o, do)
    got = (fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, sc, causal),
           *fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, sc, causal))
    if fp32:
        q, k, v, do = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
    ref = (fa.flash_bwd_dq_plain(q, k, v, lse, do, delta, sc, causal),
           *fa.flash_bwd_dkv_plain(q, k, v, lse, do, delta, sc, causal))
    torch.cuda.synchronize()
    return {name: _errors(a, r) for name, a, r in zip(('dq', 'dk', 'dv'), got, ref)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('bwd_errors: no CUDA device', file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    if not Path(fa.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f'bwd_errors: imported {fa.__file__}, not the checkout at {tree}')
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(0)
    cases = {}
    with torch.inference_mode():
        for group, shapes, kw in (('train', TRAIN, {}), ('classic', CLASSIC, {}),
                                  ('head_dim', HEAD_DIMS, {}),
                                  ('fp32', [((8, 8, 1024, 80), False)], {'fp32': True}),
                                  ('every_plan', EVERY_PLAN, {'views': True})):
            for shape, causal in shapes:
                label = f'{group} {list(shape)}' + (' causal' if causal else '')
                try:
                    cases[label] = _case(fa, gen, shape, causal, **kw)
                except (RuntimeError, ValueError) as e:   # a shape this checkout refuses
                    cases[label] = {'error': str(e)[:200]}
                torch.cuda.empty_cache()
    worst = max((e['rel_l2'], label, name) for label, c in cases.items()
                for name, e in c.items() if name != 'error')
    print(json.dumps({'tree': args.tree, 'card': gpu, 'torch': torch.__version__,
                      'worst_rel_l2': worst, 'cases': cases}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
