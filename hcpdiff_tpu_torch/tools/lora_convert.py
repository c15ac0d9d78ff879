"""LoRA files between the HCP ``.___.`` layout and the kohya/webui one
(``lora_unet_*``, ``lora_te_*``), a port of
``hcpdiff_tpu/tools/lora_convert.py``:

    python -m hcpdiff_tpu_torch.tools.lora_convert --to_webui --lora_path unet.safetensors \\
        [--lora_path_TE te.safetensors] [--lora_path_TE2 te2.safetensors] \\
        --dump_path out.safetensors [--sdxl]
    python -m hcpdiff_tpu_torch.tools.lora_convert --from_webui --lora_path kohya.safetensors \\
        --dump_path out_dir/ [--sdxl]

``--to_webui`` writes one kohya file: the UNet's layers under
``lora_unet``, the text encoder's under ``lora_te`` (SDXL: ``lora_te1``,
and ``--lora_path_TE2``'s under ``lora_te2``). ``--from_webui`` writes
``unet.safetensors``, ``text_encoder.safetensors`` and (SDXL)
``text_encoder_2.safetensors`` under ``--dump_path``, with the JAX tool's
keys (the port's layer paths). The layer names come from SD1.5's configs,
or SDXL's with ``--sdxl`` (CLIP ViT-L and, for ``lora_te2``, bigG's 32
layers). A conv layer's factors are written 4-D in both directions, its
kernel size read from the config's UNet, built on the meta device.

It refuses what it cannot convert: a LoRA bias delta (the kohya layout
has no slot for it), and a kohya key that names no LoRA factor of a layer
of the model (LyCORIS's other factors, another model's layer names, a
``lora_te2`` file without ``--sdxl``), naming the keys.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from ..ckpt import safetensors_io
from ..ckpt.diffusers_layout import clip_alias_map, unet_alias_map
from ..ckpt.formats import kohya_to_overlay, overlay_to_kohya
from ..ckpt.manager import CkptManagerSafe, auto_manager, conv_shapes
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.unet import UNet2DCondition, UNetConfig

KOHYA_PREFIXES = ('lora_unet', 'lora_te', 'lora_te1', 'lora_te2')


def on_meta(cls, cfg) -> torch.nn.Module:
    """``cls(cfg)`` on the meta device: its layers' weight shapes, no
    memory."""
    with torch.device('meta'):
        return cls(cfg)


def meta_unet(sdxl: bool) -> UNet2DCondition:
    return on_meta(UNet2DCondition, UNetConfig.sdxl() if sdxl else UNetConfig.sd15())


def te_configs(sdxl: bool) -> Dict[str, CLIPTextConfig]:
    """{kohya prefix: the text encoder's config}; ``lora_te1`` is CLIP
    ViT-L in both models, as the JAX tool reads it."""
    out = {'lora_te': CLIPTextConfig.sd15(), 'lora_te1': CLIPTextConfig.sd15()}
    if sdxl:
        out['lora_te2'] = CLIPTextConfig.sdxl_big_g()
    return out


def _overlay(path: str, aliases: Dict[str, str]):
    """The LoRA overlay of an ``.___.`` file, keyed by the port's paths; a
    layer the model does not have raises."""
    overlay = auto_manager(path).load_ckpt(path, aliases=aliases).get('lora')
    if not overlay:
        raise ValueError(f'{path} holds no LoRA layers (no lora: section)')
    unknown = sorted(set(overlay) - set(aliases))
    if unknown:
        raise ValueError(f'{path}: {len(unknown)} LoRA layers this model does not have: '
                         f'{unknown[:8]}')
    return overlay


def hcp_to_webui(unet_path: Optional[str], te_path: Optional[str], dump_path: str,
                 sdxl: bool = False, te2_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """``.___.`` LoRA files (the trainer's ``unet-N``/``text_encoder-N``)
    -> one kohya file at ``dump_path``; returns its state dict."""
    if te2_path and not sdxl:
        raise ValueError('--lora_path_TE2 is the SDXL bigG encoder\'s LoRA: pass --sdxl')
    out: Dict[str, torch.Tensor] = {}
    if unet_path:
        unet = meta_unet(sdxl)
        aliases = unet_alias_map(unet.cfg)
        overlay = _overlay(unet_path, aliases)
        out.update(overlay_to_kohya(overlay, aliases, 'lora_unet', conv_shapes(unet, overlay)))
    tes = te_configs(sdxl)
    for path, prefix in ((te_path, 'lora_te1' if sdxl else 'lora_te'), (te2_path, 'lora_te2')):
        if path:
            aliases = clip_alias_map(tes[prefix])
            out.update(overlay_to_kohya(_overlay(path, aliases), aliases, prefix))
    if not out:
        raise ValueError('nothing to convert: give --lora_path and/or --lora_path_TE')
    safetensors_io.save_file(out, dump_path)
    return out


def webui_to_hcp(lora_path: str, dump_dir: str, sdxl: bool = False) -> Dict[str, str]:
    """A kohya file -> ``.___.`` files under ``dump_dir`` ({part: path})."""
    sd = safetensors_io.load_file(lora_path)
    stray = sorted(k for k in sd if not any(k.startswith(p + '_') for p in KOHYA_PREFIXES))
    if stray:
        raise ValueError(f'{lora_path}: {len(stray)} keys under no kohya prefix '
                         f'{KOHYA_PREFIXES}: {stray[:8]}')
    tes = te_configs(sdxl)
    if not sdxl and any(k.startswith('lora_te2_') for k in sd):
        raise ValueError(f'{lora_path} holds lora_te2 (SDXL bigG) layers: pass --sdxl')
    unet = meta_unet(sdxl)
    parts = [('unet', 'lora_unet', unet, unet_alias_map(unet.cfg))]
    parts += [('text_encoder_2' if prefix == 'lora_te2' else 'text_encoder', prefix,
               on_meta(CLIPTextModel, cfg), clip_alias_map(cfg)) for prefix, cfg in tes.items()]
    written: Dict[str, str] = {}
    os.makedirs(dump_dir, exist_ok=True)
    for name, prefix, module, aliases in parts:
        overlay = kohya_to_overlay(sd, {tp: fp for fp, tp in aliases.items()}, prefix)
        if not overlay:
            continue
        if name in written:
            raise ValueError(f'{lora_path} holds text-encoder layers under both lora_te and '
                             'lora_te1')
        written[name] = os.path.join(dump_dir, f'{name}.safetensors')
        CkptManagerSafe().save_model_with_lora(written[name], module, lora_overlay=overlay)
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--to_webui', action='store_true')
    p.add_argument('--from_webui', action='store_true')
    p.add_argument('--lora_path', required=True)
    p.add_argument('--lora_path_TE', default=None)
    p.add_argument('--lora_path_TE2', default=None)
    p.add_argument('--dump_path', required=True)
    p.add_argument('--sdxl', action='store_true')
    a = p.parse_args(argv)
    if a.to_webui == a.from_webui:
        raise SystemExit('specify one of --to_webui and --from_webui')
    if a.to_webui:
        n = len(hcp_to_webui(a.lora_path, a.lora_path_TE, a.dump_path, a.sdxl, a.lora_path_TE2))
        print(f'wrote {n} tensors to {a.dump_path}')
    else:
        for name, path in webui_to_hcp(a.lora_path, a.dump_path, a.sdxl).items():
            print(f'wrote {name}: {path}')


if __name__ == '__main__':
    main()
