"""Self-contained CLIP BPE tokenizer (vocab.json + merges.txt, no network).

A copy of ``hcpdiff_tpu/utils/clip_tokenizer.py`` (standard library only),
so that the port imports nothing of the JAX package;
``tests/test_torch_port_models.py`` holds the two to the same ids.

Replaces transformers.CLIPTokenizer for the reference's tokenization duties
(hcpdiff/models/tokenizer_ex.py, hcpdiff/models/text_emb_ex.py): standard
CLIP byte-BPE with lowercasing + whitespace cleanup, plus:

- ``added_tokens``: prompt-tuning trigger words map to id ranges *past* the
  base vocab (ids >= vocab_size select rows of the runtime ``emb_ext``
  table, see models/clip.py). Multi-vector words expand to N consecutive
  ids at encode time — the tokenization-time equivalent of the reference's
  EmbeddingPTHook splice (hcpdiff/models/text_emb_ex.py:37-69).
- window packing for prompt-length expansion (N_repeats,
  hcpdiff/models/textencoder_ex.py:34-41).
"""
from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord('!'), ord('~') + 1)) + list(range(ord('¡'), ord('¬') + 1))
          + list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False else
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE)


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 model_max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token_id = vocab.get('<|startoftext|>', len(vocab) - 2)
        self.eos_token_id = vocab.get('<|endoftext|>', len(vocab) - 1)
        self.pad_token_id = self.eos_token_id
        self.vocab_size = len(vocab)
        self.cache = {'<|startoftext|>': '<|startoftext|>',
                      '<|endoftext|>': '<|endoftext|>'}
        # word -> list of extension ids (>= vocab_size)
        self.added_tokens: Dict[str, List[int]] = {}
        self._n_added = 0

    # ---- constructors ----
    @classmethod
    def from_pretrained(cls, path: str, subfolder: str = '', **kw) -> 'CLIPTokenizer':
        d = os.path.join(path, subfolder) if subfolder else path
        with open(os.path.join(d, 'vocab.json'), encoding='utf-8') as f:
            vocab = json.load(f)
        with open(os.path.join(d, 'merges.txt'), encoding='utf-8') as f:
            lines = f.read().split('\n')
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith('#') and len(l.split()) == 2]
        return cls(vocab, merges, **kw)

    def save_pretrained(self, path: str) -> None:
        """Write ``vocab.json`` and ``merges.txt``, which ``from_pretrained``
        reads, into ``path`` (added words are not written)."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, 'vocab.json'), 'w', encoding='utf-8') as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks, key=self.bpe_ranks.get)
        with open(os.path.join(path, 'merges.txt'), 'w', encoding='utf-8') as f:
            f.write('#version: 0.2\n' + ''.join(f'{a} {b}\n' for a, b in merges))

    @classmethod
    def tiny(cls, words: Sequence[str] = (), model_max_length: int = 77) -> 'CLIPTokenizer':
        """Build a tiny character-level tokenizer for tests."""
        byte_syms = list(_bytes_to_unicode().values())
        vocab = {s: i for i, s in enumerate(byte_syms)}
        vocab.update({s + '</w>': len(vocab) + i for i, s in enumerate(byte_syms)})
        merges: List[Tuple[str, str]] = []
        for w in words:
            syms = list(w[:-1]) + [w[-1] + '</w>']
            for i in range(len(syms) - 1):
                merged = ''.join(syms[:i + 2])
                if merged not in vocab:
                    vocab[merged] = len(vocab)
                merges.append((''.join(syms[:i + 1]), syms[i + 1]))
        vocab['<|startoftext|>'] = len(vocab)
        vocab['<|endoftext|>'] = len(vocab)
        return cls(vocab, merges, model_max_length=model_max_length)

    # ---- BPE ----
    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = _get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = ' '.join(word)
        self.cache[token] = out
        return out

    # ---- public API ----
    def add_word(self, word: str, n_vectors: int = 1) -> List[int]:
        """Register a prompt-tuning trigger word -> n consecutive ext ids."""
        if word in self.added_tokens:
            return self.added_tokens[word]
        ids = [self.vocab_size + self._n_added + i for i in range(n_vectors)]
        self._n_added += n_vectors
        self.added_tokens[word] = ids
        return ids

    def tokenize_words(self, text: str) -> List[int]:
        """Text -> token ids (no special tokens), expanding added words."""
        text = html.unescape(html.unescape(text or ''))
        text = re.sub(r'\s+', ' ', text).strip().lower()
        ids: List[int] = []
        # split out added trigger words first (longest match)
        if self.added_tokens:
            pattern = '(' + '|'.join(re.escape(w.lower())
                                     for w in sorted(self.added_tokens, key=len,
                                                     reverse=True)) + ')'
            parts = re.split(pattern, text)
        else:
            parts = [text]
        for part in parts:
            if not part:
                continue
            if part in self.added_tokens:
                ids.extend(self.added_tokens[part])
                continue
            for tok in _PAT.findall(part):
                tok = ''.join(self.byte_encoder[b] for b in tok.encode('utf-8'))
                ids.extend(self.encoder[t] for t in self._bpe(tok).split(' ')
                           if t in self.encoder)
        return ids

    def __call__(self, text, max_length: Optional[int] = None,
                 padding: str = 'max_length', truncation: bool = True):
        """transformers-compatible call: returns dict with input_ids [B, L]."""
        texts = [text] if isinstance(text, str) else list(text)
        max_length = max_length or self.model_max_length
        out = []
        for t in texts:
            ids = self.tokenize_words(t)
            if truncation:
                ids = ids[:max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == 'max_length' and len(ids) < max_length:
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            out.append((ids, mask))
        return {'input_ids': [o[0] for o in out],
                'attention_mask': [o[1] for o in out]}

    def encode_windows(self, text: str, n_repeats: int = 1):
        """Prompt-length expansion: pack ids into ``n_repeats`` windows of
        (model_max_length-2) content tokens, each with BOS/EOS.
        Returns int list [n_repeats * model_max_length]."""
        L = self.model_max_length
        content = L - 2
        ids = self.tokenize_words(text)[:content * n_repeats]
        windows = []
        for w in range(n_repeats):
            chunk = ids[w * content:(w + 1) * content]
            chunk = [self.bos_token_id] + chunk + [self.eos_token_id]
            chunk += [self.pad_token_id] * (L - len(chunk))
            windows.extend(chunk)
        return windows

    def decode(self, ids: Sequence[int]) -> str:
        text = ''.join(self.decoder.get(i, '') for i in ids
                       if i not in (self.bos_token_id, self.eos_token_id))
        byte_text = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return byte_text.decode('utf-8', errors='replace').replace('</w>', ' ').strip()
