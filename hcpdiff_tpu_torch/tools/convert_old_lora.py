"""A pre-0.9 HCP LoRA file in the current key layout (a port of
``hcpdiff_tpu/tools/convert_old_lora.py``):

    python -m hcpdiff_tpu_torch.tools.convert_old_lora old_lora.safetensors new_lora.safetensors

  <host>.___.layer.lora_down.weight -> <host>.___.layer.W_down
  <host>.___.layer.lora_up.weight   -> <host>.___.layer.W_up
  <host>.___.layer.lora_up.bias     -> <host>.___.layer.bias
  <host>.___.alpha                  -> unchanged

The tensors are laid out alike in the two, so this renames keys (any
``lora:``-style section prefix is kept). Either file's format follows its
extension (``.safetensors``, else a torch-pickled ``.ckpt``). The loaders
(``ckpt/formats.py:lora_state_to_overlay``) also take the old keys; this
writes files for other tools.
"""
from __future__ import annotations

import argparse
from typing import Dict, Mapping, TypeVar

from ..ckpt.manager import auto_manager

T = TypeVar('T')
_RENAMES = (
    ('layer.lora_down.weight', 'layer.W_down'),
    ('layer.lora_up.weight', 'layer.W_up'),
    ('layer.lora_up.bias', 'layer.bias'),
)


def convert_state(state: Mapping[str, T]) -> Dict[str, T]:
    """The flat state dict with the old key suffixes renamed."""
    out = {}
    for k, v in state.items():
        for old, new in _RENAMES:
            if k.endswith(old):
                k = k[:-len(old)] + new
                break
        out[k] = v
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('src', help='old-format LoRA checkpoint')
    ap.add_argument('dst', help='output path (format from extension)')
    args = ap.parse_args(argv)
    flat = auto_manager(args.src)._read(args.src)
    auto_manager(args.dst)._write(convert_state(flat), args.dst)
    print(f'converted {args.src} -> {args.dst}')


if __name__ == '__main__':
    main()
