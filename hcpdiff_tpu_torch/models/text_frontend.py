"""Prompt parsing and text encoding (counterpart of
``hcpdiff_tpu/models/text_frontend.py``, which imports JAX and so is ported
rather than imported).

- ``parse_attn_mult``: ``{text}`` / ``{text:1.5}`` nested attention-weight
  syntax -> (clean_text, per-fragment multipliers);
- ``TextEncoderFrontend.encode``: tokenize into ``n_repeats`` windows of
  77 tokens, run CLIP on all windows as one batch, re-join the windows'
  hidden states with a single BOS/EOS, and select the ``clip_skip`` layer;
  ``attention_mask`` gives the merged sequence's padding mask (the UNet's
  ``encoder_attention_mask``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..utils.clip_tokenizer import CLIPTokenizer
from .clip import CLIPTextModel

DEFAULT_EMPHASIS = 1.1


def parse_attn_mult(text: str, emphasis: float = DEFAULT_EMPHASIS
                    ) -> Tuple[str, List[Tuple[str, float]]]:
    """Parse nested ``{...}`` emphasis syntax.

    Returns (clean_text, segments) where segments is a list of
    (text_fragment, multiplier). ``{a {b:1.5}}`` gives a->1.1, b->1.5*1.1.
    """
    segments: List[Tuple[str, float]] = []
    stack: List[float] = [1.0]
    buf = ''
    i = 0
    n = len(text)

    def flush():
        nonlocal buf
        if buf:
            segments.append((buf, stack[-1]))
            buf = ''

    while i < n:
        ch = text[i]
        if ch == '{':
            flush()
            stack.append(stack[-1] * emphasis)
            i += 1
        elif ch == ':' and len(stack) > 1:
            # explicit weight: read the number up to '}'
            j = i + 1
            while j < n and text[j] not in '}':
                j += 1
            try:
                w = float(text[i + 1:j].strip())
                flush_weight = stack[-2] * w
                if buf:
                    segments.append((buf, flush_weight))
                    buf = ''
                i = j
                stack[-1] = flush_weight
            except ValueError:
                buf += ch
                i += 1
        elif ch == '}':
            flush()
            if len(stack) > 1:
                stack.pop()
            i += 1
        else:
            buf += ch
            i += 1
    flush()
    clean = ''.join(s for s, _ in segments)
    return clean, segments


@dataclasses.dataclass
class EncodedPrompt:
    input_ids: np.ndarray        # [n_windows * L]
    token_mult: np.ndarray       # [n_windows * L]


class TextEncoderFrontend:
    """Tokenizer + CLIP text model + window merge + clip_skip."""

    def __init__(self, tokenizer: CLIPTokenizer, model: CLIPTextModel,
                 n_repeats: int = 1, clip_skip: int = 0, clip_final_norm: bool = True):
        self.tokenizer = tokenizer
        self.model = model
        self.n_repeats = int(n_repeats)
        self.clip_skip = int(clip_skip)
        self.clip_final_norm = bool(clip_final_norm)

    def tokenize(self, text: str) -> EncodedPrompt:
        _, segments = parse_attn_mult(text)
        tk = self.tokenizer
        L = tk.model_max_length
        content = L - 2
        ids: List[int] = []
        mults: List[float] = []
        for frag, w in segments:
            frag_ids = tk.tokenize_words(frag)
            ids.extend(frag_ids)
            mults.extend([w] * len(frag_ids))
        total = content * self.n_repeats
        ids, mults = ids[:total], mults[:total]
        win_ids: List[int] = []
        win_mult: List[float] = []
        for w in range(self.n_repeats):
            chunk = ids[w * content:(w + 1) * content]
            m = mults[w * content:(w + 1) * content]
            pad = L - 2 - len(chunk)
            win_ids.extend([tk.bos_token_id] + chunk + [tk.eos_token_id]
                           + [tk.pad_token_id] * pad)
            win_mult.extend([1.0] + m + [1.0] * (pad + 1))
        return EncodedPrompt(np.asarray(win_ids, np.int64), np.asarray(win_mult, np.float32))

    def tokenize_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        enc = [self.tokenize(t) for t in texts]
        return (np.stack([e.input_ids for e in enc]),
                np.stack([e.token_mult for e in enc]))

    def attention_mask(self, input_ids: np.ndarray) -> np.ndarray:
        """[B, R*L] ids -> [B, R*(L-2)+2] mask over the merged sequence: 1
        up to and including each window's first EOS, 0 for the padding
        after it (the reference's ``pad_attn_bias``), windows joined as
        ``encode`` joins their hidden states."""
        tk = self.tokenizer
        L, R = tk.model_max_length, self.n_repeats
        B = input_ids.shape[0]
        ids = input_ids.reshape(B, R, L)
        eos_pos = np.argmax(ids == tk.eos_token_id, axis=-1)             # [B, R]
        win_mask = (np.arange(L)[None, None, :] <= eos_pos[..., None]).astype(np.float32)
        if R == 1:
            return win_mask[:, 0]
        return np.concatenate([win_mask[:, 0, :1],
                               win_mask[:, :, 1:L - 1].reshape(B, R * (L - 2)),
                               win_mask[:, -1, L - 1:]], axis=1)

    def _final_norm(self, x: torch.Tensor, params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Only the final LayerNorm, in fp32 (clip_skip with final norm)."""
        ln = self.model.final_layer_norm
        w = params.get('final_layer_norm.weight', ln.weight)
        b = params.get('final_layer_norm.bias', ln.bias)
        y = torch.nn.functional.layer_norm(x.float(), ln.normalized_shape, w.float(), b.float(),
                                           ln.eps)
        return y.to(x.dtype)

    def encode_ids(self, input_ids: torch.Tensor, token_mult: Optional[torch.Tensor] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None,
                   emb_ext: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, n_repeats*L] ids -> (hidden [B, n_repeats*(L-2)+2, D], pooled [B, ...]).
        Under ``no_grad``, unless ``params`` ({name: tensor}, in place of
        the model's own: the trainer's text-encoder LoRA or fine-tune)
        are given, whose gradients then flow. ``emb_ext``: the rows of
        ids past the vocabulary (``CLIPTextModel.embed_tokens``)."""
        if params is None:
            with torch.no_grad():
                return self._encode(input_ids, token_mult, {}, emb_ext)
        return self._encode(input_ids, token_mult, params, emb_ext)

    def _encode(self, input_ids, token_mult, params, emb_ext=None):
        B = input_ids.shape[0]
        L = self.tokenizer.model_max_length
        R = self.n_repeats
        ids = input_ids.reshape(B * R, L)
        mult = token_mult.reshape(B * R, L) if token_mult is not None else None
        last, pooled, hs = functional_call(self.model, dict(params), (ids,),
                                           {'embedding_multiplier': mult, 'emb_ext': emb_ext})
        if self.clip_skip > 0:
            h = hs[-(self.clip_skip + 1)]
            if self.clip_final_norm:
                h = self._final_norm(h, params)
        else:
            h = last
        D = h.shape[-1]
        h = h.reshape(B, R, L, D)
        if R == 1:
            merged = h[:, 0]
        else:
            merged = torch.cat([h[:, 0, :1], h[:, :, 1:L - 1].reshape(B, R * (L - 2), D),
                                h[:, -1, L - 1:]], dim=1)
        return merged, pooled.reshape(B, R, -1)[:, 0]

    def encode(self, texts: Sequence[str], emb_ext: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mult = self.tokenize_batch(texts)
        device = self.model.token_embedding.device
        return self.encode_ids(torch.from_numpy(ids).to(device), torch.from_numpy(mult).to(device),
                               emb_ext=emb_ext)
