"""Plain fp32 LoRA training steps: LoRA factors on the layers that regular
expressions select, merged as W + (alpha / rank) * up @ down, the text
encoder and the UNet run with the merged weights, the noise prediction's
mean squared error, its gradient (in blocks of rows), global-norm clipping
and AdamW (decoupled weight decay), each LoRA group at its own learning rate
under a linear warm-up. Every LoRA tensor, ``alpha`` included, is a trained
leaf, as the published trainer's parameter tree holds them.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint


def select_layers(module: torch.nn.Module, patterns: Sequence[str]) -> List[str]:
    """Paths of the Linear and Conv2d layers at or below a module path that
    one of the ``re:`` patterns searches into, sorted."""
    rxs = [re.compile(p[3:]) for p in patterns]
    out = []
    for name, m in module.named_modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            parts = name.split('.')
            ancestors = ['.'.join(parts[:i]) for i in range(1, len(parts) + 1)]
            if any(rx.search(a) for rx in rxs for a in ancestors):
                out.append(name)
    return sorted(out)


def merged(module: torch.nn.Module, lora: Dict[str, Dict[str, torch.Tensor]]):
    """{weight name: W + (alpha / rank) * up @ down} of the LoRA layers."""
    out = {}
    for path, f in lora.items():
        w = module.get_submodule(path).weight
        delta = (f['up'] @ f['down']) * (f['alpha'] / f['down'].shape[0])
        out[f'{path}.weight'] = w + delta.reshape(w.shape)
    return out


def warmup_lr(lr: float, warmup: int, step: int) -> float:
    """The learning rate at optimizer step ``step`` (0 first)."""
    return lr * min(1.0, step / warmup) if warmup > 0 else lr


class LoraSteps:
    """``steps`` training steps of the LoRA factors ``lora`` ({'unet': {path:
    {down, up, alpha}}, 'te': {...}}) on a frozen UNet and text encoder."""

    def __init__(self, unet, te, lora, lrs: Dict[str, float], warmup: int,
                 weight_decay: float, clip: float, alphas_cumprod: np.ndarray, eos_id: int,
                 rows_a_block: int):
        self.unet, self.te, self.lora = unet, te, lora
        self.lrs, self.warmup, self.wd, self.clip = lrs, warmup, weight_decay, clip
        self.acp = torch.as_tensor(alphas_cumprod, dtype=torch.float64)
        self.eos_id, self.rows = eos_id, rows_a_block
        self.leaves = [(part, path, k) for part in sorted(lora) for path in sorted(lora[part])
                       for k in ('alpha', 'down', 'up')]
        for part, path, k in self.leaves:
            lora[part][path][k].requires_grad_(True)
        self.m = {leaf: torch.zeros_like(self.t(leaf)) for leaf in self.leaves}
        self.grad_max = {leaf: 0.0 for leaf in self.leaves}     # each leaf's largest gradient norm
        self.v = {leaf: torch.zeros_like(self.t(leaf)) for leaf in self.leaves}
        self.count = 0

    def t(self, leaf) -> torch.Tensor:
        part, path, k = leaf
        return self.lora[part][path][k]

    def loss(self, latents, ids, noise, t) -> torch.Tensor:
        """Mean over the rows' elements of (prediction - noise)^2."""
        ctx = functional_call(self.te, merged(self.te, self.lora['te']), (ids, self.eos_id))[0]
        a = self.acp.to(latents.device)[t].float().view(-1, 1, 1, 1)
        noisy = a.sqrt() * latents + (1 - a).sqrt() * noise
        params = merged(self.unet, self.lora['unet'])
        pred = checkpoint(lambda x, c: functional_call(self.unet, params, (x, t, c)), noisy, ctx,
                          use_reentrant=False)
        return (pred - noise).square().mean()

    def step(self, batch, noise, t) -> float:
        """One step; returns the batch's loss."""
        B = batch['latents'].shape[0]
        grads = {leaf: torch.zeros_like(self.t(leaf)) for leaf in self.leaves}
        total = 0.0
        for i in range(0, B, self.rows):
            rows = slice(i, min(i + self.rows, B))
            loss = self.loss(batch['latents'][rows], batch['input_ids'][rows], noise[rows],
                             t[rows]) * ((rows.stop - rows.start) / B)
            for leaf, g in zip(self.leaves, torch.autograd.grad(
                    loss, [self.t(leaf) for leaf in self.leaves], allow_unused=True)):
                if g is not None:
                    grads[leaf] += g
            total += float(loss.detach())
        for leaf, g in grads.items():
            self.grad_max[leaf] = max(self.grad_max[leaf], float(g.double().norm()))
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        factor = min(1.0, self.clip / norm) if self.clip and norm > 0 else 1.0
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.count += 1
        with torch.no_grad():
            for leaf in self.leaves:
                lr = warmup_lr(self.lrs[leaf[0]], self.warmup, self.count - 1)
                g = grads[leaf] * factor
                p = self.t(leaf)
                p.mul_(1 - lr * self.wd)
                self.m[leaf].mul_(b1).add_(g, alpha=1 - b1)
                self.v[leaf].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[leaf] / (1 - b1 ** self.count)
                v_hat = self.v[leaf] / (1 - b2 ** self.count)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
        return total

    def first_gradients(self) -> Dict[tuple, torch.Tensor]:
        """Each leaf's first gradient as the optimizer took it (clipped),
        from its first moment after one step."""
        return {leaf: self.m[leaf] / (1 - 0.9) for leaf in self.leaves}
