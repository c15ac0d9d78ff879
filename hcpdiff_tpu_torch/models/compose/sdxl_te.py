"""SDXL's dual text encoder (counterpart of
``hcpdiff_tpu/models/compose/sdxl_te.py``, which imports JAX and so is
ported rather than imported).

Both encoders read the same token ids; their hidden states are joined on
the feature axis (768 + 1280 = 2048, SDXL's ``cross_attention_dim``) and
the pooled embedding is the second encoder's projected EOS row. SDXL's
convention is the penultimate layer (``clip_skip=1``) without the final
LayerNorm.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.clip_tokenizer import CLIPTokenizer
from ..clip import CLIPTextModel
from ..text_frontend import TextEncoderFrontend


class SDXLTokenizer:
    """The two encoders' tokenizers, driven with the same text; the second
    defaults to the first (both are CLIP BPE with one vocabulary)."""

    def __init__(self, tokenizer_l: CLIPTokenizer, tokenizer_g: Optional[CLIPTokenizer] = None):
        self.tokenizer_l = tokenizer_l
        self.tokenizer_g = tokenizer_g or tokenizer_l

    def __getattr__(self, name):
        return getattr(self.tokenizer_l, name)


class SDXLTextEncoderFrontend:
    """Encode once per encoder (by default the penultimate layer, no final
    norm, one window repeat); join the hidden states; pooled from the
    second."""

    def __init__(self, tokenizer, te1: CLIPTextModel, te2: CLIPTextModel, n_repeats: int = 1,
                 clip_skip: int = 1, clip_final_norm: bool = False):
        tk = tokenizer if isinstance(tokenizer, SDXLTokenizer) else SDXLTokenizer(tokenizer)
        self.tokenizer = tk
        self.fe1 = TextEncoderFrontend(tk.tokenizer_l, te1, n_repeats, clip_skip, clip_final_norm)
        self.fe2 = TextEncoderFrontend(tk.tokenizer_g, te2, n_repeats, clip_skip, clip_final_norm)

    def tokenize_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        return self.fe1.tokenize_batch(texts)

    def encode_ids(self, input_ids: torch.Tensor, token_mult: Optional[torch.Tensor] = None,
                   params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                   emb_ext: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX ``encode_ids_dual``: (hidden [B, S, D1 + D2], pooled).
        Under ``no_grad`` unless ``params`` ({'te': {...}, 'te2': {...}},
        each in place of its encoder's own weights, as
        ``TextEncoderFrontend.encode_ids`` takes them) are given; then the
        gradients flow into them and into ``emb_ext``'s tables."""
        ext = emb_ext or {}
        p = params if params is not None else {'te': None, 'te2': None}
        h1, _ = self.fe1.encode_ids(input_ids, token_mult, params=p.get('te'),
                                    emb_ext=ext.get('clip_L'))
        h2, pooled = self.fe2.encode_ids(input_ids, token_mult, params=p.get('te2'),
                                         emb_ext=ext.get('clip_bigG'))
        return torch.cat([h1, h2], dim=-1), pooled

    def encode(self, texts: Sequence[str], emb_ext: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hidden [B, S, D1 + D2], pooled [B, projection_dim]); ``emb_ext``:
        each encoder's prompt-tuning rows, ``{'clip_L', 'clip_bigG'}``
        (``split_sdxl_embedding``)."""
        ids, mult = self.tokenize_batch(texts)
        device = self.fe1.model.token_embedding.device
        return self.encode_ids(torch.from_numpy(ids).to(device), torch.from_numpy(mult).to(device),
                               emb_ext=emb_ext)


def split_sdxl_embedding(vectors: np.ndarray, dim_l: int = 768) -> Dict[str, np.ndarray]:
    """Split a joined SDXL embedding [n, 768 + 1280] into per-encoder tables."""
    return {'clip_L': vectors[:, :dim_l], 'clip_bigG': vectors[:, dim_l:]}


def concat_sdxl_embedding(parts: Dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate([parts['clip_L'], parts['clip_bigG']], axis=-1)


def make_sdxl_time_ids(original_size=(1024, 1024), crop_coord=(0, 0),
                       target_size=(1024, 1024)) -> np.ndarray:
    """[h_orig, w_orig, h_crop, w_crop, h_tgt, w_tgt] conditioning vector,
    from (width, height)-ordered sizes and an (x, y) crop."""
    return np.asarray([original_size[1], original_size[0],
                       crop_coord[1], crop_coord[0],
                       target_size[1], target_size[0]], np.float32)
