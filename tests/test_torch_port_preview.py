"""The port's training previewer (``loggers/preview.py``) against the JAX
package's, on the tiny world in fp32 on the CPU:

- the JAX ``ImagePreviewer`` over the JAX ``Trainer`` and the port's over
  the port's ``Trainer`` (the same weights through ``ckpt/bridge.py``, the
  same LoRA pack on the UNet and the text encoder, made nonzero), 64 px,
  3 DDIM steps, guidance 7.5 with a negative prompt, the JAX initial
  latents fed to the port: images within atol 2e-3 on [0, 1] (the UNet's
  fp32 parity bound, 1e-3 on latents, carried through three steps and
  the VAE decode);
- a port run that previews at every step has the same losses, pack and
  optimizer state, bit for bit, as one without; a ``preview_dict`` call
  leaves the pack, the trainer's generator, the modules' flags and
  weights and the remat policy as they were;
- as in JAX, the preview takes the positive branch only (a DreamArtist
  ``lora_unet_neg`` and a ControlNet in the pack change nothing), and an
  SDXL UNet cannot preview.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from hcpdiff_tpu.config import containerize as jcontainerize
from hcpdiff_tpu.loggers.preview import ImagePreviewer as JPreviewer
from hcpdiff_tpu.trainer import trainer as jtrainer
from hcpdiff_tpu_torch.config import containerize
from hcpdiff_tpu_torch.loggers.preview import ImagePreviewer
from hcpdiff_tpu_torch.trainer.step import pack_leaves
from hcpdiff_tpu_torch.trainer.trainer import Trainer
from tests.test_torch_port_trainer import (LORA, _cfg, _jax_pack_as_port, jax_world,  # noqa: F401
                                           one_torch_thread, port_world, proj)

PREVIEW = dict(prompt='a photo of cat', negative_prompt='painting', width=64, height=64,
               num_steps=3, guidance_scale=7.5, sampler='ddim', seed=42)


def _perturbed(pack, seed):
    """The JAX pack with every LoRA factor seeded (the up factors start at
    zero, which would make the LoRA invisible)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(rng.standard_normal(np.shape(x)) * 0.1, np.float32)
        if np.ndim(x) >= 2 else np.asarray(x), jax.device_get(pack))


def test_preview_matches_jax(proj, tmp_path, jax_world, monkeypatch):
    monkeypatch.setattr(jtrainer, 'build_models', lambda *a, **kw: dict(jax_world))
    mesh = jtrainer.make_mesh
    monkeypatch.setattr(jtrainer, 'make_mesh', lambda **kw: mesh(devices=jax.devices()[:1]))
    # the preview saves nothing: no orbax manager (its import alone takes
    # seconds), no latent cache (a VAE encode to compile)
    monkeypatch.setattr(jtrainer, 'OrbaxCkptManager', lambda directory: None)
    cfg = _cfg(proj, tmp_path / 'jax', **LORA)
    cfg['data']['dataset1']['cache_latents'] = False
    jt = jtrainer.Trainer(jcontainerize(cfg))
    jt.state = jt.state.replace(pack=jax.tree_util.tree_map(jax.numpy.asarray,
                                                            _perturbed(jt.state.pack, 3)))
    world = port_world(jax_world)
    tt = Trainer(containerize(_cfg(proj, tmp_path / 'port', device='cpu', **LORA)), world=world)
    with torch.no_grad():
        for dst, src in zip(pack_leaves(tt.state.pack),
                            pack_leaves(_jax_pack_as_port(jt.state.pack, world))):
            dst.copy_(src)

    jimg = np.asarray(JPreviewer(jt, **PREVIEW).preview_dict()['preview'])
    _, r_init, _ = jax.random.split(jax.random.PRNGKey(PREVIEW['seed']), 3)
    latents = torch.from_numpy(np.array(jax.random.normal(r_init, (1, 32, 32, 4))))
    randn = torch.randn
    monkeypatch.setattr(torch, 'randn', lambda *a, **kw: (
        latents.clone() if tuple(a[0]) == tuple(latents.shape) else randn(*a, **kw)))
    timg = ImagePreviewer(tt, **PREVIEW).preview_dict()['preview']
    assert timg.shape == jimg.shape == (64, 64, 3) and np.isfinite(timg).all()
    assert timg.std() > 0.01
    np.testing.assert_allclose(timg, jimg, atol=2e-3, rtol=0)


def _port_trainer(proj, exp_dir, **over):
    cfg = _cfg(proj, exp_dir, device='cpu', **LORA, **over)
    cfg['data']['dataset1']['cache_latents'] = False
    return Trainer(containerize(cfg))


def test_previews_leave_training_bitwise(proj, tmp_path):
    plain = _port_trainer(proj, tmp_path / 'plain')
    assert plain.train() == 3
    shown = _port_trainer(proj, tmp_path / 'shown', previewer={
        'image_log_step': 1, 'prompt': 'a photo of cat', 'width': 32, 'height': 32,
        'num_steps': 2})
    assert shown.previewer is not None and shown.image_log_step == 1
    assert shown.train() == 3
    assert sorted(p.name for p in (tmp_path / 'shown' / 'imgs').iterdir()) == [
        '1-preview.png', '2-preview.png', '3-preview.png']
    assert shown.history == plain.history
    for a, b in zip(pack_leaves(shown.state.pack), pack_leaves(plain.state.pack)):
        assert torch.equal(a, b)
    sa, sb = shown.state.optimizer.state_dict(), plain.state.optimizer.state_dict()
    for k in sa['state']:
        for key, v in sa['state'][k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb['state'][k][key]))

    # one preview_dict call: nothing of the trainer moves
    before = [t.clone() for t in pack_leaves(shown.state.pack)]
    weights = {n: p.clone() for n, p in shown.unet.named_parameters()}
    te = {n: p.clone() for n, p in shown.te.named_parameters()}
    gen = shown.generator.get_state()
    flags = [m.training for m in (shown.unet, shown.te, shown.vae)]
    policy, remat = shown.unet.remat_policy, shown.unet.remat
    shown.previewer.preview_dict()
    assert all(torch.equal(a, b) for a, b in zip(before, pack_leaves(shown.state.pack)))
    assert all(torch.equal(p, weights[n]) for n, p in shown.unet.named_parameters())
    assert all(torch.equal(p, te[n]) for n, p in shown.te.named_parameters())
    assert torch.equal(gen, shown.generator.get_state())
    assert flags == [m.training for m in (shown.unet, shown.te, shown.vae)]
    assert (policy, remat) == (shown.unet.remat_policy, shown.unet.remat)


def test_preview_takes_the_positive_branch_only(proj, tmp_path):
    trainer = _port_trainer(proj, tmp_path / 'a')
    previewer = ImagePreviewer(trainer, **dict(PREVIEW, width=32, height=32, num_steps=2))
    plain = previewer.preview_dict()['preview']
    pack = trainer.state.pack
    pack['lora_unet_neg'] = copy.deepcopy({p: {k: v.detach() + 0.5 for k, v in e.items()}
                                           for p, e in pack['lora_unet'].items()})
    pack['controlnet'] = {'conv_in.weight': torch.ones(4)}
    np.testing.assert_array_equal(previewer.preview_dict()['preview'], plain)


def test_sdxl_unet_cannot_preview():
    class Cfg:
        addition_embed_type = 'text_time'

    class Unet:
        cfg = Cfg()

    class Fake:
        unet = Unet()
        cfgs = {}
    with pytest.raises(ValueError, match='SDXL'):
        ImagePreviewer(Fake())
