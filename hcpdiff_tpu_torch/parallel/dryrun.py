"""One tiny LoRA train step over n CPU ranks (``gloo``), the port's
counterpart of ``__graft_entry__.py:dryrun_multichip``: it holds the mesh
(data parallelism, ZeRO, fsdp) without a second card.

    python -m hcpdiff_tpu_torch.parallel.dryrun --ranks 4 [--fsdp 2] [--zero 1]

Each rank runs the config-driven Trainer on the tiny world (UNet LoRA,
EMA, global-norm clip, the latent cache) over seeded 64 px PNGs
written to a temporary directory (two a rank), with the global batch split over the
data axis (2 rows a rank). Rank 0 prints one JSON line: the step's loss, and for the pack,
the optimizers' state and (fsdp) the frozen base the bytes one rank holds
and the bytes of the whole.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import socket
import sys
import tempfile
from typing import Optional

import numpy as np

RANK_TIMEOUT = 180


def _cfg(root: str, fsdp: int, zero: int) -> dict:
    imgs = os.path.join(root, 'imgs')
    return {
        'exp_dir': os.path.join(root, 'exp'), 'device': 'cpu', 'mixed_precision': 'fp32',
        'seed': 1, 'fsdp': fsdp,
        'train': {'train_steps': 1, 'save_step': 1, 'zero': zero, 'max_grad_norm': 1.0,
                  'preemption': False, 'optimizer': {'_target_': 'optim.adamw'},
                  'scheduler': {'name': 'constant', 'num_warmup_steps': 0}},
        'model': {'pretrained_model_name_or_path': 'tiny', 'gradient_checkpointing': False,
                  'ema': {'decay_max': 0.9999}},
        'logger': [{'_target_': 'CLILogger', 'log_step': 1}],
        'lora_unet': [{'lr': 1e-3, 'rank': 4, 'layers': ['re:.*attn[12]\\.to_(q|k|v)$']}],
        'data': {'dataset1': {
            'batch_size': 2, 'cache_latents': True,
            'source': {'s1': {'img_root': imgs,
                              'caption_file': os.path.join(imgs, 'captions.json')}},
            'bucket': {'_target_': 'FixedBucket', 'target_size': 32}}},
        'tokenizer_pt': {'emb_dir': None, 'train': None},
    }


def write_images(root: str, n: int = 4, seed: int = 0) -> None:
    from ..utils.images import write_png
    imgs = os.path.join(root, 'imgs')
    os.makedirs(imgs, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_png(os.path.join(imgs, f'img_{i}.png'),
                  rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    with open(os.path.join(imgs, 'captions.json'), 'w') as f:
        json.dump({f'img_{i}': f'a photo of cat {i}' for i in range(n)}, f)


def _rank(rank: int, world: int, port: int, root: str, fsdp: int, zero: int) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    from ..config import containerize
    from ..trainer.step import pack_leaves
    from ..trainer.trainer import Trainer
    torch.set_num_threads(1)
    trainer = Trainer(containerize(_cfg(root, fsdp, zero)))
    trainer.train()
    st = trainer.state
    opt = sum(v.numel() * v.element_size() for o in (st.optimizer, st.optimizer_pt)
              if o is not None for s in o.state.values() for v in s.values()
              if torch.is_tensor(v))
    held = {'pack': sum(t.numel() * t.element_size() for t in pack_leaves(st.pack)),
            'optimizer_state': opt}
    whole = {'pack': sum(int(np.prod(s)) * torch.empty(0, dtype=d).element_size()
                         for s, d in trainer.dp.shapes)}
    if trainer.frozen_shards is not None:
        held['frozen'] = trainer.frozen_shards.held_bytes()
        whole['frozen'] = trainer.frozen_shards.full_bytes()
    # the optimizer state of the whole: under ZeRO every data rank's share
    box = torch.tensor([opt], dtype=torch.float64)
    if zero:
        dist.all_reduce(box, group=trainer.mesh.group('data'))
    whole['optimizer_state'] = int(box.item())
    if rank == 0:
        print(json.dumps({'ranks': world, 'mesh': trainer.mesh.shape, 'zero': zero,
                          'loss': trainer.history[-1], 'bytes_held_by_rank_0': held,
                          'bytes_whole': whole}), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def dryrun(ranks: int, fsdp: int = 1, zero: int = 0, root: Optional[str] = None) -> int:
    """Run the step on ``ranks`` processes; the exit code of the worst."""
    if ranks % fsdp:
        raise ValueError(f'fsdp={fsdp} does not divide ranks={ranks}')
    with tempfile.TemporaryDirectory() as tmp:
        root = root or tmp
        write_images(root, n=2 * ranks)
        port = _free_port()
        ctx = mp.get_context('spawn')
        procs = [ctx.Process(target=_rank, args=(r, ranks, port, root, fsdp, zero))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(RANK_TIMEOUT)
        codes = []
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
                codes.append(124)
            else:
                codes.append(p.exitcode)
    return max(codes, key=abs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description='One tiny LoRA step over n CPU gloo ranks')
    p.add_argument('--ranks', type=int, default=2)
    p.add_argument('--fsdp', type=int, default=1)
    p.add_argument('--zero', type=int, default=0)
    args = p.parse_args(argv)
    return dryrun(args.ranks, args.fsdp, args.zero)


if __name__ == '__main__':
    sys.exit(main())
