"""A diffusers-layout directory -> a webui/LDM single-file checkpoint (a
port of ``hcpdiff_tpu/tools/diffusers2sd.py``):

    python -m hcpdiff_tpu_torch.tools.diffusers2sd --model_path models/my-sd \\
        --checkpoint_path out/model.safetensors

``unet/``, ``vae/`` and ``text_encoder/`` are read with the port's
loader (``models/factory.py:load_state_dict``: safetensors, else
``.bin``), renamed by ``ckpt/ldm_convert.py``'s maps and written as one
``.safetensors``, or, for another extension,
``torch.save({'state_dict': ...})``. Tensors keep their dtype. The text
encoder goes where an LDM reader looks for it: SD1.x's CLIP (``quick_gelu``
in its ``config.json``) under ``cond_stage_model.transformer.``, SD2.x's
open_clip tower (``gelu``) under ``cond_stage_model.model.`` with q, k
and v joined (the JAX tool writes both under SD1.x's prefix, so its SD2
files read back as SD1). A directory weight that no map names, and an
SDXL directory (``text_encoder_2/``, a layout this tool does not write),
raise.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from ..ckpt import safetensors_io
from ..ckpt.ldm_convert import TE_LDM_PREFIX, te_diffusers_to_openclip, unet_diffusers_to_ldm, \
    vae_diffusers_to_ldm
from ..models.factory import is_sdxl_dir, load_state_dict


def te_is_openclip(te_dir: str) -> bool:
    """SD2.x's open_clip tower: ``gelu`` where OpenAI's CLIP has
    ``quick_gelu`` (the factory's default when the config names none)."""
    with open(os.path.join(te_dir, 'config.json')) as f:
        return json.load(f).get('hidden_act', 'quick_gelu') == 'gelu'


def convert(model_path: str, checkpoint_path: str) -> None:
    if is_sdxl_dir(model_path):
        raise ValueError(f'{model_path} is an SDXL directory (text_encoder_2/): diffusers2sd '
                         'writes SD1.x/SD2.x single files only')
    out: Dict[str, torch.Tensor] = {}
    for sub, convert in (('unet', unet_diffusers_to_ldm), ('vae', vae_diffusers_to_ldm)):
        sd = load_state_dict(os.path.join(model_path, sub))
        ldm = convert(sd)
        if len(ldm) != len(sd):
            raise ValueError(f'{model_path}/{sub}: {len(sd) - len(ldm)} weights have no LDM '
                             'name (not an SD1.x/SD2.x-shaped model)')
        out.update(ldm)
    te_dir = os.path.join(model_path, 'text_encoder')
    te = load_state_dict(te_dir)
    out.update(te_diffusers_to_openclip(te) if te_is_openclip(te_dir)
               else {TE_LDM_PREFIX + k: v for k, v in te.items()})
    if checkpoint_path.endswith('.safetensors'):
        safetensors_io.save_file(out, checkpoint_path)
    else:
        os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)
        torch.save({'state_dict': {k: v.contiguous() for k, v in out.items()}}, checkpoint_path)
    print(f'wrote {checkpoint_path}')


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--model_path', required=True)
    p.add_argument('--checkpoint_path', required=True)
    a = p.parse_args(argv)
    convert(a.model_path, a.checkpoint_path)


if __name__ == '__main__':
    main()
