"""Plain fp32 text-to-image: the tokenizer, the scaled-linear noise
schedule, DPM-Solver++ 2M and the classifier-free-guidance loop, written
from their published definitions (CLIP's byte-level BPE with no merges,
Stable Diffusion's scheduler settings, diffusers'
``DPMSolverMultistepScheduler`` with ``algorithm_type='dpmsolver++'``,
``solver_order=2`` in k-space, linspace timesteps).
"""
from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np
import torch

from .models import encode_text


def byte_symbols() -> List[int]:
    """GPT-2's byte order: the printable bytes first, then the rest; a
    byte's symbol id is its place in this list."""
    bs = (list(range(ord('!'), ord('~') + 1)) + list(range(ord('\xa1'), ord('\xac') + 1))
          + list(range(ord('\xae'), ord('\xff') + 1)))
    return bs + [b for b in range(256) if b not in bs]


class ByteTokenizer:
    """CLIP's tokenizer with a byte-level vocabulary and no merges: each
    byte is a token, the last byte of a word takes the ``</w>`` form (ids
    256 on), then BOS and EOS; a prompt is cut to 75 tokens, framed by
    BOS and EOS and padded with EOS to 77. Takes prompts of lowercase
    ASCII words split by single spaces, the traffic's alphabet."""

    length = 77

    def __init__(self):
        self.index = {b: i for i, b in enumerate(byte_symbols())}
        self.bos, self.eos = 512, 513

    def ids(self, text: str) -> List[int]:
        if not re.fullmatch(r'[a-z]+( [a-z]+)*', text):
            raise ValueError(f'prompt outside the traffic alphabet: {text!r}')
        toks: List[int] = []
        for word in text.split(' '):
            b = word.encode('ascii')
            toks += [self.index[c] for c in b[:-1]] + [256 + self.index[b[-1]]]
        toks = toks[:self.length - 2]
        return [self.bos] + toks + [self.eos] * (self.length - 1 - len(toks))


def alphas_cumprod(num_train: int = 1000, beta_start: float = 0.00085,
                   beta_end: float = 0.012) -> np.ndarray:
    """SD's scaled-linear schedule's cumulative alphas, float64."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def dpmpp_2m_sigmas(num_steps: int, num_train: int = 1000):
    """(timesteps, sigmas + [0]) of SD's scaled-linear schedule at linspace
    spacing, in float64."""
    acp = alphas_cumprod(num_train)
    ts = np.linspace(0, num_train - 1, num_steps).round()[::-1].astype(np.int64)
    sigmas = np.sqrt((1 - acp[ts]) / acp[ts])
    return ts, np.append(sigmas, 0.0)


@torch.no_grad()
def txt2img(unet, vae, encoders, prompts: Sequence[str], negatives: Sequence[str],
            noise: torch.Tensor, steps: int, guidance: float, size: int, layer: int,
            text_time: bool):
    """One request in fp32: (context [2B, S, D], first UNet output [2B, h,
    w, 4], final latents [B, h, w, 4], images [B, H, W, 3] in [0, 1]).
    ``noise`` [B, h, w, 4] is the request's initial draw; negatives come
    first in every doubled batch."""
    dev = noise.device
    tok = ByteTokenizer()
    ids = torch.tensor([tok.ids(t) for t in list(negatives) + list(prompts)], device=dev)
    ctx, pooled = encode_text(encoders, ids, tok.eos, layer)
    extra = {}
    if text_time:
        tid = torch.tensor([size, size, 0, 0, size, size], dtype=torch.float32, device=dev)
        extra = {'pooled': pooled, 'time_ids': tid.repeat(ids.shape[0], 1)}
    ts, sigmas = dpmpp_2m_sigmas(steps)
    x = noise.float() * float(np.sqrt(sigmas[0] ** 2 + 1))
    prev_x0, first = None, None
    for i in range(steps):
        s, s_next = float(sigmas[i]), float(sigmas[i + 1])
        x_in = torch.cat([x, x]) / (s * s + 1) ** 0.5
        t = torch.full((x_in.shape[0],), int(ts[i]), device=dev)
        out = unet(x_in, t, ctx, **extra)
        first = out if first is None else first
        e_neg, e_pos = out.chunk(2)
        x0 = x - s * (e_neg + guidance * (e_pos - e_neg))
        if s_next == 0:
            x = x0
            break
        h = np.log(s) - np.log(s_next)
        if prev_x0 is None:
            mix = x0
        else:
            r = (np.log(float(sigmas[i - 1])) - np.log(s)) / h
            mix = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * prev_x0
        x = (s_next / s) * x - float(np.expm1(-h)) * mix
        prev_x0 = x0
    images = torch.cat([vae.decode_image(x[i:i + 1]) for i in range(x.shape[0])])
    return ctx, first, x, images
