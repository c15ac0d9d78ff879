"""The port's tools (``hcpdiff_tpu_torch/tools/``, the kohya and LDM key
maps, ``CkptManagerWebui``, ``utils/profiling.py``) against the JAX
package's, on the CPU, with seeded numpy/torch inputs:

- kohya/webui LoRA keys: the port's ``overlay_to_kohya``/
  ``kohya_to_overlay`` give the JAX functions' keys and equal arrays on a
  bridged overlay with linear and conv layers (the JAX ones called with
  ``conv_shapes``); the ``lora_convert`` CLI writes the JAX tool's files
  both ways on ``.___.`` files with SD1.5 and SDXL layer names where the
  JAX tool is right, and keeps what it drops (a conv layer's 4-D factors,
  bigG's layers past 12); a bias delta and a key it cannot map raise;
- ``convert_old_lora``: the same keys;
- the LDM maps (UNet, VAE, text encoder, both ways, the open_clip split,
  ``is_sd2_checkpoint``), ``split_ldm_checkpoint`` and
  ``load_webui_parts`` on a narrow SD1.x-shaped model (4 levels, 2
  resnets a level): equal keys, bitwise-equal tensors;
- ``diffusers2sd`` then ``sd2diffusers``: the JAX tools' files, and the
  directory's tensors back bitwise; the fixed configs read back as
  ``UNetConfig.sd15()``/``sd21()``, ``VAEConfig.sd()`` and
  ``CLIPTextConfig.sd15()``/``sd2()``; an SD2-shaped directory's
  encoder written as open_clip (the JAX open_clip split reads it back)
  and back bitwise; an SDXL directory and the JAX tool's unread options
  refused;
- ``embedding_convert``, ``convert_caption_txt2json``, ``init_proj`` and
  ``gen_from_ptlist.load_prompts`` against the JAX tools' outputs;
  ``embedding_convert`` takes one direction and refuses a file of the
  other;
  ``gen_from_ptlist.main`` writes N JPEGs at tiny width on the CPU;
- ``analyze_trace`` on a trace ``utils/profiling.trace`` wrote, and on a
  card-shaped trace: kernels on their stream's lane with the families of
  ``utils/profiling.py``, summed by family as ``profile_txt2img`` reads
  them.
"""
import argparse
import contextlib
import gzip
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load

from hcpdiff_tpu.ckpt import formats as jf
from hcpdiff_tpu.ckpt import ldm_convert as jldm
from hcpdiff_tpu.ckpt.manager import CkptManagerSafe as JCkptManagerSafe
from hcpdiff_tpu.ckpt.manager import CkptManagerWebui as JCkptManagerWebui
from hcpdiff_tpu.models import factory as jfactory
from hcpdiff_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from hcpdiff_tpu.models.unet import UNetConfig as JUNetConfig
from hcpdiff_tpu.tools import convert_caption_txt2json as jcaption
from hcpdiff_tpu.tools import convert_old_lora as jold
from hcpdiff_tpu.tools import diffusers2sd as jd2s
from hcpdiff_tpu.tools import embedding_convert as jemb
from hcpdiff_tpu.tools import gen_from_ptlist as jgen
from hcpdiff_tpu.tools import init_proj as jinit
from hcpdiff_tpu.tools import lora_convert as jlora
from hcpdiff_tpu.tools import sd2diffusers as js2d
from hcpdiff_tpu_torch.ckpt import diffusers_layout as tdl
from hcpdiff_tpu_torch.ckpt import formats as tf
from hcpdiff_tpu_torch.ckpt import ldm_convert as tldm
from hcpdiff_tpu_torch.ckpt import safetensors_io
from hcpdiff_tpu_torch.ckpt.manager import CkptManagerWebui
from hcpdiff_tpu_torch.models import factory as tfactory
from hcpdiff_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from hcpdiff_tpu_torch.models.layers import init_flax_like
from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from hcpdiff_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from hcpdiff_tpu_torch.tools import analyze_trace
from hcpdiff_tpu_torch.tools import convert_caption_txt2json as tcaption
from hcpdiff_tpu_torch.tools import convert_old_lora as told
from hcpdiff_tpu_torch.tools import diffusers2sd as td2s
from hcpdiff_tpu_torch.tools import embedding_convert as temb
from hcpdiff_tpu_torch.tools import gen_from_ptlist as tgen
from hcpdiff_tpu_torch.tools import init_proj as tinit
from hcpdiff_tpu_torch.tools import lora_convert as tlora
from hcpdiff_tpu_torch.tools import sd2diffusers as ts2d
from hcpdiff_tpu_torch.utils import jpeg, profiling
from tests.torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = 4


def _equal_dicts(a, b):
    """Two {key: array or tensor} dicts: the same keys, bitwise-equal
    values of one shape and dtype. A LoRA's ``alpha`` may be [1] on one
    side and [] on the other: the JAX writers pass each tensor through
    ``np.ascontiguousarray``, which makes a 0-d array 1-d; the port
    writes it 0-d, as kohya's files hold it."""
    assert sorted(a) == sorted(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else np.asarray(a[k])
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else np.asarray(b[k])
        if k.endswith('alpha') and {x.shape, y.shape} <= {(), (1,)}:
            x, y = x.reshape(()), y.reshape(())
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert np.array_equal(x, y), k


# ------------------------------------------------------------- LoRA ----

# (path, fan_in, out, JAX conv kernel shape (kh, kw, cin, cout) or None)
UNET_LAYERS = (('down_0_attn_0.transformer_blocks_0.attn1.to_q', 320, 320, None),
               ('mid_attn.transformer_blocks_0.ff.out', 5120, 1280, None),
               ('down_0_res_0.conv1', 2880, 320, (3, 3, 320, 320)),
               ('conv_in', 36, 320, (3, 3, 4, 320)))
TE_LAYERS = (('layers_3.self_attn.q_proj', 768, 768, None), ('layers_11.fc1', 768, 3072, None))


def _jax_overlay(layers, seed, convs=True):
    """A JAX-layout overlay: down [fan_in, r] ((kh, kw, cin) order), up
    [r, out], alpha."""
    rng = np.random.default_rng(seed)
    return {p: {'down': rng.standard_normal((fan_in, RANK)).astype(np.float32),
                'up': rng.standard_normal((RANK, out)).astype(np.float32),
                'alpha': np.asarray(rng.uniform(1, 8), np.float32)}
            for p, fan_in, out, ks in layers if convs or ks is None}


def _bridge(joverlay, layers):
    """The JAX overlay in the port's layout: down [r, fan_in] in (cin, kh,
    kw) order, up [out, r]."""
    kernel = {p: ks for p, _, _, ks in layers}
    out = {}
    for p, e in joverlay.items():
        down = e['down']
        if kernel[p] is not None:
            kh, kw, cin, _ = kernel[p]
            down = down.reshape(kh, kw, cin, RANK).transpose(3, 2, 0, 1).reshape(RANK, -1)
        else:
            down = down.T
        out[p] = {'down': torch.from_numpy(np.ascontiguousarray(down)),
                  'up': torch.from_numpy(np.ascontiguousarray(e['up'].T)),
                  'alpha': torch.from_numpy(e['alpha'])}
    return out


def _port_conv_shapes(layers):
    return {p: (ks[3], ks[2], ks[0], ks[1]) for p, _, _, ks in layers if ks is not None}


def _jax_conv_shapes(layers):
    return {p: ks for p, _, _, ks in layers if ks is not None}


@pytest.mark.parametrize('part', ['unet', 'te'])
def test_kohya_keys_match_jax_both_ways(part):
    if part == 'unet':
        layers, prefix = UNET_LAYERS, 'lora_unet'
        jmap, tmap = (jfactory.unet_alias_map(JUNetConfig.sd15()),
                      tdl.unet_alias_map(UNetConfig.sd15()))
    else:
        layers, prefix = TE_LAYERS, 'lora_te'
        jmap, tmap = (jfactory.clip_alias_map(JCLIPTextConfig.sd15()),
                      tdl.clip_alias_map(CLIPTextConfig.sd15()))
    assert jmap == tmap
    jov = _jax_overlay(layers, 1)
    jsd = jf.overlay_to_kohya(jov, jmap, prefix, conv_shapes=_jax_conv_shapes(layers))
    tsd = tf.overlay_to_kohya(_bridge(jov, layers), tmap, prefix,
                              conv_shapes=_port_conv_shapes(layers))
    _equal_dicts(jsd, tsd)
    if part == 'unet':
        assert tsd['lora_unet_down_blocks_0_resnets_0_conv1.lora_down.weight'].shape == (
            RANK, 320, 3, 3)
    rev = {v: k for k, v in tmap.items()}
    back = tf.kohya_to_overlay(tsd, rev, prefix)
    jback = jf.kohya_to_overlay(jsd, rev, prefix)
    want = _bridge(jback, layers)
    assert sorted(back) == sorted(want)
    for p in back:
        for f in ('down', 'up', 'alpha'):
            assert torch.equal(back[p][f], want[p][f]), (p, f)


def _jax_lora_file(path, joverlay, aliases, conv_shapes=None):
    """A ``.___.`` file as the trainers write it (keys through the alias map)."""
    JCkptManagerSafe().save_model_with_lora(path, lora_overlay=joverlay, aliases=aliases,
                                            conv_shapes=conv_shapes)


def test_lora_convert_cli_matches_jax_both_ways(tmp_path):
    junet = jfactory.unet_alias_map(JUNetConfig.sd15())
    jte = jfactory.clip_alias_map(JCLIPTextConfig.sd15())
    unet_f, te_f = str(tmp_path / 'unet.safetensors'), str(tmp_path / 'te.safetensors')
    _jax_lora_file(unet_f, _jax_overlay(UNET_LAYERS, 2, convs=False), junet)
    _jax_lora_file(te_f, _jax_overlay(TE_LAYERS, 3), jte)
    # --to_webui
    jout, tout = str(tmp_path / 'j.safetensors'), str(tmp_path / 't.safetensors')
    jlora.hcp_to_webui(unet_f, te_f, jout)
    tlora.main(['--to_webui', '--lora_path', unet_f, '--lora_path_TE', te_f,
                '--dump_path', tout])
    _equal_dicts(np_load(jout), np_load(tout))
    # --from_webui, from the JAX tool's kohya file
    jdir, tdir = str(tmp_path / 'jdir'), str(tmp_path / 'tdir')
    jlora.webui_to_hcp(jout, jdir)
    tlora.main(['--from_webui', '--lora_path', jout, '--dump_path', tdir])
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [
        'text_encoder.safetensors', 'unet.safetensors']
    for name in os.listdir(jdir):
        _equal_dicts(np_load(os.path.join(jdir, name)), np_load(os.path.join(tdir, name)))


def test_lora_convert_writes_conv_layers_4d(tmp_path):
    """A conv layer's factors leave and enter the port's tool 4-D, as the
    JAX ``overlay_to_kohya``/``save_model_with_lora`` write them when
    given ``conv_shapes``; the JAX tool passes none and writes a 2-D
    ``lora_down`` (ROADMAP.md, "Reference behaviours")."""
    junet = jfactory.unet_alias_map(JUNetConfig.sd15())
    jov = _jax_overlay(UNET_LAYERS, 4)
    unet_f = str(tmp_path / 'unet.safetensors')
    _jax_lora_file(unet_f, jov, junet, _jax_conv_shapes(UNET_LAYERS))
    tout = str(tmp_path / 't.safetensors')
    tlora.main(['--to_webui', '--lora_path', unet_f, '--dump_path', tout])
    want = jf.overlay_to_kohya(jov, junet, 'lora_unet', conv_shapes=_jax_conv_shapes(UNET_LAYERS))
    _equal_dicts(want, np_load(tout))
    jout = str(tmp_path / 'j.safetensors')
    jlora.hcp_to_webui(unet_f, None, jout)
    assert np_load(jout)['lora_unet_conv_in.lora_down.weight'].shape == (RANK, 36)
    tdir = str(tmp_path / 'tdir')
    tlora.main(['--from_webui', '--lora_path', tout, '--dump_path', tdir])
    ref = str(tmp_path / 'ref.safetensors')
    JCkptManagerSafe().save_model_with_lora(
        ref, lora_overlay=jf.kohya_to_overlay(want, {v: k for k, v in junet.items()}),
        conv_shapes=_jax_conv_shapes(UNET_LAYERS))
    _equal_dicts(np_load(ref), np_load(os.path.join(tdir, 'unet.safetensors')))


def test_lora_convert_sdxl(tmp_path):
    """SDXL: the UNet's, lora_te1's (ViT-L) and lora_te2's (bigG) layers
    both ways where the JAX tool maps them; bigG's layers past 12, which
    the JAX tool maps through a 12-layer CLIP and drops, are kept."""
    rng = np.random.default_rng(5)

    def factors(fan_in, out):
        return {'lora_down.weight': rng.standard_normal((RANK, fan_in)).astype(np.float32),
                'lora_up.weight': rng.standard_normal((out, RANK)).astype(np.float32),
                'alpha': np.asarray(4.0, np.float32)}

    mods = {'lora_unet_down_blocks_1_attentions_0_transformer_blocks_1_attn2_to_k': (2048, 640),
            'lora_te1_text_model_encoder_layers_3_self_attn_q_proj': (768, 768),
            'lora_te2_text_model_encoder_layers_5_mlp_fc2': (5120, 1280)}
    sd = {f'{m}.{k}': v for m, shape in mods.items() for k, v in factors(*shape).items()}
    src = str(tmp_path / 'kohya.safetensors')
    safetensors_io.save_file({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    jdir, tdir = str(tmp_path / 'jdir'), str(tmp_path / 'tdir')
    jlora.webui_to_hcp(src, jdir, sdxl=True)
    tlora.main(['--from_webui', '--sdxl', '--lora_path', src, '--dump_path', tdir])
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [
        'text_encoder.safetensors', 'text_encoder_2.safetensors', 'unet.safetensors']
    for name in os.listdir(jdir):
        _equal_dicts(np_load(os.path.join(jdir, name)), np_load(os.path.join(tdir, name)))
    # back to kohya through the port: the same file
    back = str(tmp_path / 'back.safetensors')
    tlora.main(['--to_webui', '--sdxl', '--lora_path', os.path.join(tdir, 'unet.safetensors'),
                '--lora_path_TE', os.path.join(tdir, 'text_encoder.safetensors'),
                '--lora_path_TE2', os.path.join(tdir, 'text_encoder_2.safetensors'),
                '--dump_path', back])
    _equal_dicts(sd, np_load(back))
    # a bigG layer past 12: kept by the port, dropped by the JAX tool
    deep = dict(sd, **{f'lora_te2_text_model_encoder_layers_20_mlp_fc1.{k}': v
                       for k, v in factors(1280, 5120).items()})
    src2 = str(tmp_path / 'deep.safetensors')
    safetensors_io.save_file({k: torch.from_numpy(v) for k, v in deep.items()}, src2)
    jlora.webui_to_hcp(src2, str(tmp_path / 'jdeep'), sdxl=True)
    tlora.webui_to_hcp(src2, str(tmp_path / 'tdeep'), sdxl=True)
    deep_key = 'lora:layers_20.fc1.___.layer.W_down'
    assert deep_key in np_load(str(tmp_path / 'tdeep' / 'text_encoder_2.safetensors'))
    assert deep_key not in np_load(str(tmp_path / 'jdeep' / 'text_encoder_2.safetensors'))


def test_lora_convert_refuses_what_it_cannot_convert(tmp_path):
    jov = _jax_overlay(TE_LAYERS, 6)
    tov = _bridge(jov, TE_LAYERS)
    tov['layers_3.self_attn.q_proj']['bias'] = torch.ones(768)
    with pytest.raises(ValueError, match='bias'):
        tf.overlay_to_kohya(tov, tdl.clip_alias_map(CLIPTextConfig.sd15()), 'lora_te')
    biased = dict(jov)
    biased['layers_3.self_attn.q_proj'] = dict(jov['layers_3.self_attn.q_proj'],
                                               bias=np.ones(768, np.float32))
    te_f = str(tmp_path / 'te.safetensors')
    _jax_lora_file(te_f, biased, jfactory.clip_alias_map(JCLIPTextConfig.sd15()))
    with pytest.raises(ValueError, match='bias'):
        tlora.main(['--to_webui', '--lora_path_TE', te_f, '--lora_path', '',
                    '--dump_path', str(tmp_path / 'o.safetensors')])

    good = jf.overlay_to_kohya(jov, jfactory.clip_alias_map(JCLIPTextConfig.sd15()), 'lora_te')
    cases = {'unknown layer': {'lora_unet_not_a_layer.lora_down.weight': np.zeros((4, 8))},
             'lycoris factor': {'lora_te_text_model_encoder_layers_3_self_attn_q_proj.hada_w1_a':
                                np.zeros((4, 8))},
             'no prefix': {'model.diffusion_model.x.weight': np.zeros(3)},
             'te2 without sdxl': {'lora_te2_text_model_encoder_layers_3_mlp_fc1.alpha':
                                  np.zeros(())}}
    for what, extra in cases.items():
        src = str(tmp_path / f'{what}.safetensors')
        safetensors_io.save_file({k: torch.as_tensor(np.asarray(v, np.float32))
                                  for k, v in {**good, **extra}.items()}, src)
        name = next(iter(extra)).split('.')[0]
        with pytest.raises(ValueError, match=name if what != 'te2 without sdxl' else '--sdxl'):
            tlora.webui_to_hcp(src, str(tmp_path / 'out'))
    # the JAX function drops the unknown layer without a word
    out = jf.kohya_to_overlay({**good, **cases['unknown layer']},
                              {v: k for k, v in jfactory.unet_alias_map(
                                  JUNetConfig.sd15()).items()})
    assert out == {}


def test_convert_old_lora_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    flat = {f'lora:{h}.___.{p}': rng.standard_normal((4, 8)).astype(np.float32)
            for h in ('down_0_attn_0.transformer_blocks_0.attn1.to_q', 'layers_1.fc2')
            for p in ('layer.lora_down.weight', 'layer.lora_up.weight', 'layer.lora_up.bias',
                      'alpha')}
    assert list(told.convert_state(flat)) == list(jold.convert_state(flat))
    src = str(tmp_path / 'old.safetensors')
    safetensors_io.save_file({k: torch.from_numpy(v) for k, v in flat.items()}, src)
    for dst in ('new.safetensors', 'new.ckpt'):
        told.main([src, str(tmp_path / f't_{dst}')])
        monkeypatch.setattr(sys, 'argv', ['convert_old_lora', src, str(tmp_path / f'j_{dst}')])
        jold.main()
        if dst.endswith('.ckpt'):
            got = torch.load(str(tmp_path / f't_{dst}'), weights_only=True)
            want = torch.load(str(tmp_path / f'j_{dst}'), weights_only=True)
        else:
            got, want = (np_load(str(tmp_path / f'{w}_{dst}')) for w in 'tj')
        _equal_dicts(want, got)


# -------------------------------------------------------------- LDM ----

NARROW_UNET = UNetConfig(block_out_channels=(32, 32, 64, 64), num_heads=(2, 2, 2, 2),
                         cross_attention_dim=32, norm_num_groups=8)
NARROW_VAE = VAEConfig(block_out_channels=(16, 16, 32, 32), norm_num_groups=4)
NARROW_TE = CLIPTextConfig.tiny()


def _modules(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (init_flax_like(UNet2DCondition(NARROW_UNET), gen),
            init_flax_like(AutoencoderKL(NARROW_VAE), gen),
            init_flax_like(CLIPTextModel(NARROW_TE), gen))


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    """A narrow SD1.x-shaped diffusers-layout directory (F32)."""
    d = str(tmp_path_factory.mktemp('narrow') / 'sd')
    for sub, m in zip(('unet', 'vae', 'text_encoder'), _modules()):
        tdl.write_module(m, os.path.join(d, sub))
    return d


def _dir_state(d, sub):
    return tfactory.load_state_dict(os.path.join(d, sub))


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize('part', ['unet', 'vae'])
def test_ldm_maps_match_jax_both_ways(model_dir, part):
    sd = _dir_state(model_dir, part)
    to_ldm = {'unet': (tldm.unet_diffusers_to_ldm, jldm.unet_diffusers_to_ldm),
              'vae': (tldm.vae_diffusers_to_ldm, jldm.vae_diffusers_to_ldm)}[part]
    from_ldm = {'unet': (tldm.unet_ldm_to_diffusers, jldm.unet_ldm_to_diffusers),
                'vae': (tldm.vae_ldm_to_diffusers, jldm.vae_ldm_to_diffusers)}[part]
    ldm = to_ldm[0](sd)
    _equal_dicts(to_ldm[1](_np(sd)), ldm)
    assert len(ldm) == len(sd)
    back = from_ldm[0](ldm)
    _equal_dicts(from_ldm[1](_np(ldm)), back)
    _equal_dicts(sd, back)
    if part == 'vae':      # the decoder's up blocks run the other way in LDM
        assert torch.equal(ldm['first_stage_model.decoder.up.3.block.0.conv1.weight'],
                           sd['decoder.up_blocks.0.resnets.0.conv1.weight'])
        assert ldm['first_stage_model.decoder.mid.attn_1.q.weight'].dim() == 4


def _openclip_state(seed=8, width=32, layers=2):
    rng = np.random.default_rng(seed)
    p = tldm.TE_LDM_PREFIX_V2
    sd = {p + 'token_embedding.weight': (NARROW_TE.vocab_size, width),
          p + 'positional_embedding': (77, width), p + 'ln_final.weight': (width,),
          p + 'ln_final.bias': (width,), p + 'text_projection': (width, width),
          p + 'logit_scale': ()}
    for i in range(layers):
        b = f'{p}transformer.resblocks.{i}.'
        sd.update({b + 'ln_1.weight': (width,), b + 'ln_1.bias': (width,),
                   b + 'ln_2.weight': (width,), b + 'ln_2.bias': (width,),
                   b + 'attn.in_proj_weight': (3 * width, width),
                   b + 'attn.in_proj_bias': (3 * width,),
                   b + 'attn.out_proj.weight': (width, width), b + 'attn.out_proj.bias': (width,),
                   b + 'mlp.c_fc.weight': (4 * width, width), b + 'mlp.c_fc.bias': (4 * width,),
                   b + 'mlp.c_proj.weight': (width, 4 * width), b + 'mlp.c_proj.bias': (width,)})
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in sd.items()}


def test_text_encoder_maps_match_jax(model_dir):
    te = _dir_state(model_dir, 'text_encoder')
    ldm = {tldm.TE_LDM_PREFIX + k: v for k, v in te.items()}
    assert not tldm.is_sd2_checkpoint(ldm) and not jldm.is_sd2_checkpoint(_np(ldm))
    _equal_dicts(jldm.te_ldm_to_diffusers(_np(ldm)), tldm.te_ldm_to_diffusers(ldm))
    _equal_dicts(te, tldm.te_ldm_to_diffusers(ldm))
    oc = _openclip_state()
    toc = {k: torch.from_numpy(v) for k, v in oc.items()}
    assert tldm.is_sd2_checkpoint(toc) and jldm.is_sd2_checkpoint(oc)
    got = tldm.te_openclip_to_diffusers(toc)
    _equal_dicts(jldm.te_openclip_to_diffusers(oc), {k: v.contiguous() for k, v in got.items()})
    # the split q/k/v load into the port's CLIP at that width
    cfg = CLIPTextConfig.tiny(num_hidden_layers=2, hidden_act='gelu')
    port = tdl.to_port(tdl.clip_canonical(got), tdl.clip_key_map(cfg), 'open_clip')
    assert torch.equal(port['layers_1.self_attn.k_proj.weight'],
                       toc[tldm.TE_LDM_PREFIX_V2 + 'transformer.resblocks.1.attn.in_proj_weight']
                       [32:64])


def test_openclip_inverse_against_the_jax_split():
    oc = {k: torch.from_numpy(v) for k, v in _openclip_state().items()}
    te = {k: torch.from_numpy(v) for k, v in jldm.te_openclip_to_diffusers(
        {k: v.numpy() for k, v in oc.items()}).items()}
    back = tldm.te_diffusers_to_openclip(te)
    kept = {k: v for k, v in oc.items()
            if not k.endswith(('text_projection', 'logit_scale'))}
    _equal_dicts(kept, back)
    _equal_dicts(te, {k: torch.from_numpy(v) for k, v in jldm.te_openclip_to_diffusers(
        {k: v.numpy() for k, v in back.items()}).items()})
    te['text_model.embeddings.position_ids'] = torch.arange(77)[None]
    assert sorted(tldm.te_diffusers_to_openclip(te)) == sorted(back)
    with pytest.raises(ValueError, match='only'):
        tldm.te_diffusers_to_openclip({k: v for k, v in te.items()
                                       if not k.endswith('layers.1.self_attn.v_proj.bias')})
    with pytest.raises(ValueError, match='text_projection'):
        tldm.te_diffusers_to_openclip({**te, 'text_projection.weight': torch.zeros(32, 32)})


def _single_file(model_dir, sd2=False):
    """The directory as one LDM state dict, with the keys a real file
    carries beside the weights (EMA, the schedule's buffers)."""
    out = dict(tldm.unet_diffusers_to_ldm(_dir_state(model_dir, 'unet')))
    out.update(tldm.vae_diffusers_to_ldm(_dir_state(model_dir, 'vae')))
    if sd2:
        out.update({k: torch.from_numpy(v) for k, v in _openclip_state().items()})
    else:
        out.update({tldm.TE_LDM_PREFIX + k: v
                    for k, v in _dir_state(model_dir, 'text_encoder').items()})
    out['model_ema.decay'] = torch.tensor(0.9999)
    out['alphas_cumprod'] = torch.linspace(0.99, 0.01, 10)
    return out


@pytest.mark.parametrize('ext', ['.safetensors', '.ckpt'])
@pytest.mark.parametrize('sd2', [False, True], ids=['sd1', 'sd2'])
def test_split_and_load_webui_parts_match_jax(model_dir, tmp_path, ext, sd2):
    sd = _single_file(model_dir, sd2)
    path = str(tmp_path / f'model{ext}')
    if ext == '.ckpt':
        torch.save({'state_dict': sd, 'global_step': 12}, path)
    else:
        safetensors_io.save_file(sd, path)
    got = CkptManagerWebui.load_webui_parts(path)
    want = JCkptManagerWebui.load_webui_parts(path)
    assert sorted(got) == sorted(want) == ['text_encoder', 'unet', 'vae']
    for part in got:
        _equal_dicts(want[part], {k: v.contiguous() for k, v in got[part].items()})
    split = tldm.split_ldm_checkpoint(sd)
    for part in got:
        assert sorted(split[part]) == sorted(got[part])
    if not sd2:
        for part in ('unet', 'vae', 'text_encoder'):
            _equal_dicts(_dir_state(model_dir, part), got[part])


def test_load_webui_parts_refuses_a_pickle_of_objects(model_dir, tmp_path):
    path = str(tmp_path / 'lightning.ckpt')
    torch.save({'state_dict': _single_file(model_dir),
                'hyper_parameters': argparse.Namespace(lr=1e-4)}, path)
    with pytest.raises(ValueError, match='weights_only'):
        CkptManagerWebui.load_webui_parts(path)
    parts = CkptManagerWebui.load_webui_parts(path, allow_pickle=True)
    _equal_dicts(_dir_state(model_dir, 'vae'), parts['vae'])


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize('ext', ['.safetensors', '.ckpt'])
def test_diffusers2sd_then_sd2diffusers(model_dir, tmp_path, ext):
    single = str(tmp_path / f'sd{ext}')
    td2s.main(['--model_path', model_dir, '--checkpoint_path', single])
    jsingle = str(tmp_path / f'jsd{ext}')
    jd2s.convert(model_dir, jsingle)
    if ext == '.ckpt':
        got = torch.load(single, weights_only=True)['state_dict']
        want = torch.load(jsingle, weights_only=True)['state_dict']
    else:
        got, want = np_load(single), np_load(jsingle)
    _equal_dicts(want, got)
    out, jout = str(tmp_path / 'back'), str(tmp_path / 'jback')
    ts2d.main(['--checkpoint_path', single, '--dump_path', out])
    js2d.convert(single, jout)
    assert _tree(out) == _tree(jout) == [
        'model_index.json', 'scheduler/scheduler_config.json', 'text_encoder/config.json',
        'text_encoder/model.safetensors', 'unet/config.json',
        'unet/diffusion_pytorch_model.safetensors', 'vae/config.json',
        'vae/diffusion_pytorch_model.safetensors']
    for f in _tree(out):
        if f.endswith('.json'):
            assert json.load(open(os.path.join(out, f))) == json.load(open(os.path.join(jout, f)))
        else:
            _equal_dicts(np_load(os.path.join(jout, f)), np_load(os.path.join(out, f)))
    for sub in ('unet', 'vae', 'text_encoder'):
        _equal_dicts(_dir_state(model_dir, sub), _dir_state(out, sub))


@pytest.fixture(scope='module')
def sd2_dir(model_dir, tmp_path_factory):
    """The narrow directory with an open_clip-shaped (``gelu``) encoder."""
    d = str(tmp_path_factory.mktemp('narrow_sd2') / 'sd2')
    for sub in ('unet', 'vae'):
        shutil.copytree(os.path.join(model_dir, sub), os.path.join(d, sub))
    te = CLIPTextModel(CLIPTextConfig.tiny(hidden_act='gelu'))
    tdl.write_module(init_flax_like(te, torch.Generator().manual_seed(3)),
                     os.path.join(d, 'text_encoder'))
    return d


@pytest.mark.parametrize('ext', ['.safetensors', '.ckpt'])
def test_diffusers2sd_writes_an_sd2_encoder_as_open_clip(sd2_dir, tmp_path, ext):
    single, jsingle = str(tmp_path / f'sd2{ext}'), str(tmp_path / f'jsd2{ext}')
    td2s.convert(sd2_dir, single)
    jd2s.convert(sd2_dir, jsingle)
    if ext == '.ckpt':
        got, want = (torch.load(f, weights_only=True)['state_dict'] for f in (single, jsingle))
    else:
        got, want = np_load(single), np_load(jsingle)
    # the UNet and VAE as the JAX tool writes them; the encoder where the
    # JAX tool writes SD1.x's prefix, the open_clip tower the JAX split reads
    te_keys = [k for k in got if k.startswith('cond_stage_model.')]
    assert te_keys and all(k.startswith(tldm.TE_LDM_PREFIX_V2) for k in te_keys)
    assert all(k.startswith(tldm.TE_LDM_PREFIX) for k in want if k.startswith('cond_stage'))
    _equal_dicts({k: v for k, v in want.items() if not k.startswith('cond_stage_model.')},
                 {k: v for k, v in got.items() if not k.startswith('cond_stage_model.')})
    got_np = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in got.items()}
    assert jldm.is_sd2_checkpoint(got_np)
    _equal_dicts(_dir_state(sd2_dir, 'text_encoder'), jldm.te_openclip_to_diffusers(got_np))
    out = str(tmp_path / 'back')
    ts2d.main(['--checkpoint_path', single, '--dump_path', out])
    for sub in ('unet', 'vae', 'text_encoder'):
        _equal_dicts(_dir_state(sd2_dir, sub), _dir_state(out, sub))
    assert json.load(open(os.path.join(out, 'text_encoder', 'config.json'))) == \
        ts2d.SD2_TE_CONFIG
    sched = json.load(open(os.path.join(out, 'scheduler', 'scheduler_config.json')))
    assert sched['prediction_type'] == 'v_prediction'


@pytest.mark.parametrize('case', ['sdxl_dir', 'original_config_file', 'vae_path'])
def test_diffusers2sd_and_sd2diffusers_refuse(model_dir, tmp_path, case, capsys):
    if case == 'sdxl_dir':
        d = str(tmp_path / 'xl')
        shutil.copytree(model_dir, d)
        shutil.copytree(os.path.join(d, 'text_encoder'), os.path.join(d, 'text_encoder_2'))
        with pytest.raises(ValueError, match='SDXL'):
            td2s.convert(d, str(tmp_path / 'xl.safetensors'))
        assert not os.path.exists(tmp_path / 'xl.safetensors')
        return
    single = str(tmp_path / 'sd.safetensors')
    td2s.convert(model_dir, single)
    with pytest.raises(SystemExit):
        ts2d.main(['--checkpoint_path', single, '--dump_path', str(tmp_path / 'out'),
                   f'--{case}', str(tmp_path / 'x')])
    assert 'unrecognized arguments' in capsys.readouterr().err
    assert not os.path.exists(tmp_path / 'out')


def test_sd2diffusers_configs_read_back_as_the_port_configs(tmp_path):
    read = {'unet': tfactory.unet_cfg_from_json, 'vae': tfactory.vae_cfg_from_json,
            'te': tfactory.clip_cfg_from_json}
    assert read['unet'](ts2d.SD15_UNET_CONFIG) == UNetConfig.sd15()
    assert read['unet'](ts2d.SD2_UNET_CONFIG) == UNetConfig.sd21()
    assert read['vae'](ts2d.SD_VAE_CONFIG) == VAEConfig.sd()
    assert read['te'](ts2d.SD15_TE_CONFIG) == CLIPTextConfig.sd15()
    assert read['te'](ts2d.SD2_TE_CONFIG) == CLIPTextConfig.sd2()
    for name in ('SD15_UNET_CONFIG', 'SD2_UNET_CONFIG', 'SD_VAE_CONFIG', 'SD15_TE_CONFIG',
                 'SD2_TE_CONFIG'):
        assert getattr(ts2d, name) == getattr(js2d, name)


def test_sd2diffusers_sd2_file_and_vae_only(model_dir, tmp_path):
    path = str(tmp_path / 'sd2.safetensors')
    safetensors_io.save_file(_single_file(model_dir, sd2=True), path)
    out, jout = str(tmp_path / 'out'), str(tmp_path / 'jout')
    ts2d.convert(path, out, half=True)
    js2d.convert(path, jout, half=True)
    for f in _tree(out):
        if f.endswith('.json'):
            assert json.load(open(os.path.join(out, f))) == json.load(open(os.path.join(jout, f)))
        else:
            _equal_dicts(np_load(os.path.join(jout, f)), np_load(os.path.join(out, f)))
    sched = json.load(open(os.path.join(out, 'scheduler', 'scheduler_config.json')))
    assert sched['prediction_type'] == 'v_prediction'
    vae = str(tmp_path / 'vae.safetensors')
    safetensors_io.save_file({k[len(tldm.VAE_LDM_PREFIX):]: v for k, v in _single_file(
        model_dir).items() if k.startswith(tldm.VAE_LDM_PREFIX)}, vae)
    ts2d.main(['--vae_pt_path', vae, '--dump_path', str(tmp_path / 'vae')])
    _equal_dicts(_dir_state(model_dir, 'vae'), _dir_state(str(tmp_path), 'vae'))
    with pytest.raises(ValueError, match='no'):
        ts2d.convert(vae, str(tmp_path / 'not_a_model'))


# ------------------------------------------------- the other CLIs ----

@pytest.mark.parametrize('case', ['webui', 'sdxl_from_webui', 'sdxl_to_webui'])
def test_embedding_convert_matches_jax(tmp_path, case):
    rng = np.random.default_rng(9)
    src = str(tmp_path / 'word.pt')
    if case == 'webui':
        torch.save({'string_to_param': {'*': torch.from_numpy(
            rng.standard_normal((3, 32)).astype(np.float32))}, 'name': 'word', 'step': 5}, src)
    elif case == 'sdxl_from_webui':
        torch.save({'clip_l': torch.from_numpy(rng.standard_normal((2, 768)).astype(np.float32)),
                    'clip_g': torch.from_numpy(rng.standard_normal((2, 1280)).astype(np.float32))},
                   src)
    else:
        tf.save_webui_embedding(src, rng.standard_normal((2, 2048)).astype(np.float32), 'word')
    sdxl, to_webui = case != 'webui', case == 'sdxl_to_webui'
    got, want = str(tmp_path / 't.pt'), str(tmp_path / 'j.pt')
    temb.main(['--to_webui' if to_webui else '--from_webui', '--path', src, '--dump_path', got]
              + (['--sdxl'] if sdxl else []))
    jemb.convert(src, want, sdxl, to_webui)
    a, b = (torch.load(p, weights_only=True) for p in (got, want))
    assert sorted(a) == sorted(b)
    if 'string_to_param' in a:
        assert torch.equal(a['string_to_param']['*'], b['string_to_param']['*'])
        assert (a['name'], a['step']) == (b['name'], b['step'])
    else:
        assert torch.equal(a['clip_l'], b['clip_l']) and torch.equal(a['clip_g'], b['clip_g'])


@pytest.mark.parametrize('case', ['no_direction', 'both_directions', 'sdxl_from_hcp',
                                  'sdxl_to_split', 'split_without_sdxl'])
def test_embedding_convert_refuses(tmp_path, case):
    rng = np.random.default_rng(10)
    src, dst = str(tmp_path / 'word.pt'), str(tmp_path / 'out.pt')
    if case in ('sdxl_to_split', 'split_without_sdxl'):
        torch.save({'clip_l': torch.zeros(2, 768), 'clip_g': torch.zeros(2, 1280)}, src)
    else:
        tf.save_webui_embedding(src, rng.standard_normal((2, 2048)).astype(np.float32), 'word')
    flags = {'no_direction': ['--sdxl'], 'both_directions': ['--to_webui', '--from_webui'],
             'sdxl_from_hcp': ['--from_webui', '--sdxl'], 'sdxl_to_split': ['--to_webui', '--sdxl'],
             'split_without_sdxl': ['--from_webui']}[case]
    raises = SystemExit if 'direction' in case else ValueError
    with pytest.raises(raises, match='one of' if raises is SystemExit else 'clip_'):
        temb.main(flags + ['--path', src, '--dump_path', dst])
    assert not os.path.exists(dst)


def test_caption_txt2json_and_init_proj_match_jax(tmp_path, monkeypatch):
    data = tmp_path / 'imgs'
    data.mkdir()
    for i, cap in enumerate(['a cat', 'ein Hund ü ', '  two\nlines  ']):
        (data / f'{i:03d}.txt').write_text(cap, encoding='utf-8')
    got = tcaption.main(['--data_root', str(data), '--out_file', str(tmp_path / 't.json')])
    want = jcaption.convert(str(data), str(tmp_path / 'j.json'))
    assert open(got, 'rb').read() == open(want, 'rb').read()
    assert tcaption.convert(str(data)) == str(data / 'image_captions.json')
    trees = {}
    for name, fn in (('jax', jinit.main), ('port', tinit.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        fn()
        trees[name] = {f: open(os.path.join(d, f), 'rb').read() for f in _tree(str(d))}
    assert trees['jax'] == trees['port']
    assert {'cfgs/infer/text2img.yaml', 'prompt_tuning_template/object.txt'} <= set(trees['port'])
    assert os.path.isdir(tmp_path / 'port' / 'embs') and os.path.isdir(tmp_path / 'port' / 'exps')


def test_gen_from_ptlist(tmp_path):
    prompts = ['a photo of a cat', 'a painting of a dog, oil', 'cat, dog']
    txt, csv_path = tmp_path / 'p.txt', tmp_path / 'p.csv'
    txt.write_text('\n'.join(prompts[:2]) + '\n\n')
    csv_path.write_text('"a photo of a cat",x\n"cat, dog",y\n')
    for path in (txt, csv_path):
        assert tgen.load_prompts(str(path)) == jgen.load_prompts(str(path))
    out = str(tmp_path / 'out')
    viser, imgs = tgen.main([
        '--cfg', os.path.join(ROOT, 'cfgs', 'infer', 'text2img.yaml'), '--prompt_file', str(txt),
        '--out_dir', out, '--num_per_prompt', '2', '--image_type', 'jpg', '--quality', '90',
        'pretrained_model=tiny', 'device=cpu', 'dtype=fp32', 'infer_args.width=32',
        'infer_args.height=32', 'infer_args.inference_steps=3', 'bs=1', 'seed=5'])
    assert imgs.shape == (4, 32, 32, 3) and np.isfinite(imgs).all()
    assert sorted(os.listdir(out)) == sorted([f'{i}-img.jpg' for i in range(4)]
                                             + [f'{i}-img.yaml' for i in range(4)])
    want = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    for i in range(4):
        data = open(os.path.join(out, f'{i}-img.jpg'), 'rb').read()
        assert data == jpeg.encode_jpeg(want[i], 90)
    # the second image of a prompt is drawn at seed + 1
    again = viser.vis_images(prompts[1], viser.cfgs.neg_prompt, seed=6)
    np.testing.assert_array_equal(again[0], imgs[3])
    assert not np.array_equal(imgs[2], imgs[3])


def test_analyze_trace_reads_a_profiling_trace(tmp_path):
    log_dir = str(tmp_path / 'trace')
    a = torch.randn(32, 32)
    with profiling.trace(log_dir):
        (a @ a).relu().sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith('.pt.trace.json.gz')
    rows = analyze_trace.main([log_dir, '50'])
    names = {r['name'] for r in rows if r['lane'].startswith('CPU')}
    assert {'aten::matmul', 'aten::relu', 'aten::sum'} <= names
    assert all(r['family'] == '' for r in rows)


def test_profile_txt2img_reads_its_trace_through_analyze_trace(monkeypatch):
    """``kernel_breakdown`` traces one request and sums the trace's device
    rows by family; here the request is a CPU op and the trace the
    card-shaped one, written where ``trace`` was asked to write."""
    from hcpdiff_tpu_torch.tools import profile_txt2img as ptx
    seen = []

    @contextlib.contextmanager
    def card_trace(log_dir):
        seen.append(log_dir)
        yield
        _card_trace(log_dir)

    monkeypatch.setattr(ptx, 'trace', card_trace)
    monkeypatch.setattr(ptx, 'request', lambda pipe, batch, size: torch.ones(4).sum())
    fams, top, d_calls = ptx.kernel_breakdown(None, 1, 64)
    assert list(fams) == [fam for fam, _, _ in _by_time(CARD_KERNELS)]
    assert [(fam, n) for _, n, _, fam in top] == [(fam, n) for fam, _, n in
                                                 _by_time(CARD_KERNELS)]
    assert d_calls == 0 and not os.path.exists(seen[0])


def test_step_timer_matches_jax(monkeypatch):
    from hcpdiff_tpu.utils import profiling as jprofiling
    ticks, timers = [], []
    for mod in (profiling, jprofiling):
        clock = iter([0.0, 0.1, 0.35, 0.4, 0.9])
        # each module's own name for the clock, not the time module itself
        monkeypatch.setattr(mod, 'time', types.SimpleNamespace(perf_counter=lambda: next(clock)))
        timers.append(mod.StepTimer(0.8))
        ticks.append([timers[-1].tick() for _ in range(4)])
    assert ticks[0] == ticks[1]
    assert timers[0].ema_ms == timers[1].ema_ms and timers[0].steps_per_sec > 0


CARD_KERNELS = {
    'void hcp::(anonymous namespace)::flash_fwd_kernel<hcp::Plan<40> >(bf16 const*)':
    ('A flash_attention', 40.0, 10),
    'void hcp::(anonymous namespace)::ffn_gemm_kernel<hcp::(anonymous namespace)::'
    'Tile<true, 64, 4, 2> >(hcp::GemmParams)': ('B geglu_dense', 30.0, 16),
    'void hcp::(anonymous namespace)::ffn_gemm_kernel<hcp::(anonymous namespace)::'
    'Tile<false, 128, 4, 1> >(hcp::GemmParams)': ('C fused_dense', 20.0, 16),
    'void hcp::(anonymous namespace)::gn_kernel<__nv_bfloat16, float>(bf16 const*)':
    ('D group_norm_silu', 10.0, 61)}


def _card_trace(d):
    """A trace shaped as the card's under ``d``: the kernels on the GPU's
    stream lane, one host op on the CPU's."""
    meta = [{'ph': 'M', 'name': 'process_name', 'pid': 0, 'tid': 0, 'args': {'name': 'python'}},
            {'ph': 'M', 'name': 'process_labels', 'pid': 0, 'tid': 0, 'args': {'labels': 'GPU 0'}},
            {'ph': 'M', 'name': 'thread_name', 'pid': 0, 'tid': 7, 'args': {'name': 'stream 7 '}},
            {'ph': 'M', 'name': 'process_name', 'pid': 99, 'tid': 0, 'args': {'name': 'python'}},
            {'ph': 'M', 'name': 'process_labels', 'pid': 99, 'tid': 0, 'args': {'labels': 'CPU'}},
            {'ph': 'M', 'name': 'thread_name', 'pid': 99, 'tid': 99,
             'args': {'name': 'thread 99 (python)'}}]
    events = list(meta)
    for name, (_, us, n) in CARD_KERNELS.items():
        events += [{'ph': 'X', 'cat': 'kernel', 'name': name, 'pid': 0, 'tid': 7, 'ts': i,
                    'dur': us} for i in range(n)]
    events += [{'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'pid': 99, 'tid': 99, 'ts': 0,
                'dur': 5000.0}]
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, 'host_1.1.pt.trace.json.gz'), 'wt') as f:
        json.dump({'traceEvents': events}, f)


def _by_time(kernels):
    return sorted(kernels.values(), key=lambda v: -v[1] * v[2])


def test_analyze_trace_puts_kernels_on_their_stream(tmp_path):
    """The card-shaped trace: kernel events on the GPU's stream lane, each
    with its family (A-D by the port's symbols), summed by family."""
    d = str(tmp_path / 'card')
    _card_trace(d)
    rows = [r for r in analyze_trace.analyze(d, 10) if r['device']]
    assert [(r['family'], r['events'], r['lane']) for r in rows] == [
        (fam, n, 'GPU 0 / stream 7') for fam, _, n in _by_time(CARD_KERNELS)]
    assert analyze_trace.analyze(d, 1)[0]['name'] == 'aten::mm'
    fams = analyze_trace.by_family(analyze_trace.analyze(d, None))
    # the events' durations summed one by one: equal to us * n up to rounding
    assert [(fam, f['launches'], round(f['ms'], 9)) for fam, f in fams.items()] == [
        (fam, n, round(us * n / 1000.0, 9)) for fam, us, n in _by_time(CARD_KERNELS)]
    with pytest.raises(FileNotFoundError):
        analyze_trace.analyze(str(tmp_path / 'nothing'))
