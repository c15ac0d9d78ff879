"""The PyTorch port's LoRA training slice (schedule and loss, LoRA overlay
and bridge, assemble, AdamW with global-norm clipping, the train step,
remat) against the JAX package's, at tiny widths in fp32 on the CPU.

Both packages get the same weights (``random_params`` through the bridge),
the same LoRA factors (``lora_overlay_from_params``), the same batch, and
the noise and timesteps that ``jax.random`` drew inside the JAX step. The
JAX UNet runs XLA attention on the CPU; the port's level-0 self-attention
at 32x32 latents (S=1024) goes through the flash ``autograd.Function`` and
its plain forward and backward. Tolerances: 1e-6 where both compute the
same few fp32 operations; for a whole step, 1e-4 relative on loss and
grad_norm and 2e-6 absolute on the updated factors (each step moves them
by up to lr = 1e-3; see ADAM_EPS).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from hcpdiff_tpu.adapt import overlay as jov
from hcpdiff_tpu.diffusion import losses as jlosses
from hcpdiff_tpu.diffusion.schedules import NoiseSchedule as JSchedule
from hcpdiff_tpu.models import clip as jclip
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.trainer import optimizers as jopt
from hcpdiff_tpu.trainer import step as jstep
from hcpdiff_tpu_torch.adapt import overlay as tov
from hcpdiff_tpu_torch.ckpt.bridge import (load_params, lora_overlay_from_params,
                                           state_dict_from_params)
from hcpdiff_tpu_torch.diffusion import losses as tlosses
from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule as TSchedule
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import layers as tlayers
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.trainer import optimizers as topt
from hcpdiff_tpu_torch.trainer import step as tstep
from hcpdiff_tpu_torch.trainer.assemble import assemble, lora_base_weights, make_unet_apply
from tests.torch_port_common import random_params

# bench_train.py's LoRA layer patterns
PATTERNS = ['re:.*attn[12]\\.to_(q|k|v|out)$', 're:.*ff\\.(proj|out)$']
# Adam's eps for the step parity test: with the default 1e-8 the first
# steps are lr * sign(g), and a gradient element at fp32 noise level, whose
# sign the two frameworks' summation orders decide, moves by a full lr.
# At 1e-3 an update is continuous in g below |g| ~ 1e-3.
ADAM_EPS = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def unet_pair():
    jm = junet.UNet2DCondition(junet.UNetConfig.tiny(), dtype=jnp.float32)
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]), jnp.zeros((1, 77, 32)),
                           seed=30)
    return jm, params


# ---------------------------------------------------------------- (e) ----

def test_lora_layers_and_merge_match_jax(unet_pair):
    """bench_train's patterns select the same layers in both packages, and
    the merged weights agree through the overlay bridge (a conv LoRA
    included, whose fan_in order differs between the layouts)."""
    _, params = unet_pair
    tm = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    assert tov.module_paths(tm) == jov.module_paths(params)
    jlayers = jov.get_match_layers(PATTERNS, jov.module_paths(params))
    assert tov.get_match_layers(PATTERNS, tov.module_paths(tm)) == jlayers
    # 4 transformer blocks x (2 x 4 attention projections + 2 feed-forward)
    assert len(jlayers) == 40

    specs = [{'layers': PATTERNS, 'rank': 4, 'alpha': 2.0, 'scale': 0.5},
             {'layers': ['conv_in'], 'rank': 2}]
    overlay, scales = jov.make_lora_overlay(jax.random.PRNGKey(3), params, specs)
    rng = np.random.default_rng(31)
    overlay = {p: dict(e, up=rng.standard_normal(np.shape(e['up'])).astype(np.float32))
               for p, e in _numpy_tree(overlay).items()}
    merged = state_dict_from_params(_numpy_tree(jov.merge_overlays(params, [overlay], [scales])))
    base = state_dict_from_params(_numpy_tree(params))
    ported = tov.merge_overlays(base, [lora_overlay_from_params(overlay, tm)], [scales])
    for path in overlay:
        name = f'{path}.weight'
        np.testing.assert_allclose(ported[name].numpy(), merged[name].numpy(), atol=1e-6)


def test_make_lora_overlay_shapes():
    """Port-side init: down [r, fan_in] within the kaiming bound, up zeros,
    float ranks as a fraction of out_features."""
    tm = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    gen = torch.Generator().manual_seed(0)
    ov, scales = tov.make_lora_overlay(gen, tm, [{'layers': PATTERNS, 'rank': 0.25}])
    e = ov['down_0_attn_0.transformer_blocks_0.ff.proj']     # Linear(32, 256)
    assert e['down'].shape == (64, 32) and e['up'].shape == (256, 64)
    assert float(e['down'].abs().max()) <= (6 / 32) ** 0.5 and not e['up'].any()
    assert set(scales.values()) == {1.0}


# ---------------------------------------------------------------- (f) ----

@pytest.mark.parametrize('pred', ['epsilon', 'v_prediction', 'sample'])
def test_schedule_training_side_matches_jax(pred):
    rng = np.random.default_rng(32)
    x0, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 499, 999])
    js, ts = JSchedule.make(prediction_type=pred), TSchedule.make(prediction_type=pred)
    np.testing.assert_allclose(ts.snr, np.asarray(js.snr), rtol=1e-6)
    for name in ('add_noise', 'target'):
        ref = np.asarray(getattr(js, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
        out = getattr(ts, name)(_t(x0), _t(noise), _t(t))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize('name', sorted(jlosses.LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(33)
    pred, target = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([1, 400, 998])
    jl = jlosses.LOSSES[name](noise_scheduler=JSchedule.make(), gamma=2.0)
    tl = tlosses.LOSSES[name](noise_scheduler=TSchedule.make(), gamma=2.0)
    ref = np.asarray(jl(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(t)))
    np.testing.assert_allclose(tl(_t(pred), _t(target), _t(t)).numpy(), ref, rtol=1e-5,
                               atol=1e-6)


def test_clip_by_global_norm_is_optax_formula():
    g = [torch.full((4,), 3.0), torch.full((2, 2), 4.0)]           # norm 10
    norm = topt.clip_by_global_norm_(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(topt.global_norm(g)) == pytest.approx(1.0)
    small = [torch.full((4,), 0.1)]
    topt.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.full((4,), 0.1))


# ------------------------------------------------------------ (g), (h) ----

def _clip_pair():
    jm = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny())
    params = random_params(jm, jnp.zeros((1, 77), jnp.int32), seed=34)
    return jm, params, load_params(tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()), params)


def _jax_draws(rng, latents_shape, accum, lo, hi):
    """The noise and t that build_train_step's forward_loss draws (step.py
    :104-109), per microbatch."""
    keys = [rng] if accum == 1 else list(jax.random.split(rng, accum))
    out = []
    for key in keys:
        r_noise, r_t = jax.random.split(key)
        noise = jax.random.normal(r_noise, latents_shape)
        t = jax.random.randint(r_t, (latents_shape[0],), lo, hi)
        out.append((_t(noise), _t(t)))
    return out


@pytest.mark.parametrize('case', ['plain', 'accum_ema', 'fused'])
def test_train_step_matches_jax(unet_pair, case, monkeypatch):
    """(g) two LoRA steps of the tiny UNet + tiny CLIP: loss, grad_norm and
    the updated factors (and the EMA) against jax build_train_step, with
    Min-SNR, AdamW after a global-norm clip at 1.0; the accumulating case
    also weights the loss by an att_mask and per-sample loss_weight. The
    fused case runs the port's UNet with fused_sublayers=True (kernels
    G-J's plain versions and autograd.Functions) against the JAX UNet with
    HCP_PALLAS_CONV/LN/PROJ(/FORCE)=1, its Pallas kernels in interpret mode
    (16x16 latents, to keep the time down)."""
    accum, use_ema = (2, True) if case == 'accum_ema' else (1, False)
    pred = 'v_prediction' if case == 'accum_ema' else 'epsilon'
    lo, hi = (100, 900) if case == 'accum_ema' else (0, None)
    fused = case == 'fused'
    B, lat = 2, 16 if fused else 32
    if fused:
        for k in ('HCP_PALLAS_CONV', 'HCP_PALLAS_LN', 'HCP_PALLAS_PROJ', 'HCP_PALLAS_FORCE'):
            monkeypatch.setenv(k, '1')
    jm, params = unet_pair
    jte, te_params, tte = _clip_pair()
    rng = np.random.default_rng(35)
    lead = (accum,) if accum > 1 else ()
    batch = {'latents': rng.standard_normal(lead + (B, lat, lat, 4)).astype(np.float32),
             'input_ids': rng.integers(0, 1000, lead + (B, 77)).astype(np.int32)}
    if case == 'accum_ema':     # per-pixel mask and per-sample weights on the loss
        batch['att_mask'] = (rng.random(lead + (B, lat, lat)) > 0.3).astype(np.float32)
        batch['loss_weight'] = rng.uniform(0.5, 2.0, lead + (B,)).astype(np.float32)

    # JAX, as bench_train.py builds its step (fp32 here)
    jsched = JSchedule.make(prediction_type=pred)
    overlay, scales = jov.make_lora_overlay(jax.random.PRNGKey(2), params,
                                            [{'layers': PATTERNS, 'rank': 4}])
    jtx = jopt.make_optimizer('adamw', lr=1e-3, clip_norm=1.0, weight_decay=1e-4, eps=ADAM_EPS)
    cfg = dict(grad_accum=accum, min_timestep=lo, max_timestep=hi)
    jfn = jax.jit(jstep.build_train_step(
        lambda p, x, t, ctx, **e: jm.apply({'params': p}, x, t, ctx),
        lambda p, ids, tm, ext: jte.apply({'params': p}, ids, emb_ext=ext,
                                          embedding_multiplier=tm)[:2],
        jsched, jlosses.MinSNRLoss(jsched), jtx, None, jstep.StepConfig(**cfg),
        {'lora_unet': scales}))
    jstate = jstep.init_train_state({'lora_unet': overlay}, jtx, use_ema=use_ema)
    frozen = {'unet': params, 'te': te_params}

    # the port, on the same weights and factors
    tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny(), fused_sublayers=fused),
                     params).requires_grad_(False)
    tte.requires_grad_(False)
    pack = {'lora_unet': lora_overlay_from_params(_numpy_tree(overlay), tm)}
    tsched = TSchedule.make(prediction_type=pred)
    tfn = tstep.build_train_step(
        make_unet_apply(tm), lambda ids, tm_: tte(ids, embedding_multiplier=tm_)[:2],
        tsched, tlosses.MinSNRLoss(tsched), tstep.StepConfig(**cfg), {'lora_unet': scales})
    tstate = tstep.init_train_state(
        pack, topt.make_optimizer('adamw', lr=1e-3, clip_norm=1.0, weight_decay=1e-4,
                                  eps=ADAM_EPS),
        use_ema=use_ema)
    tfrozen = {'unet': lora_base_weights(tm, pack['lora_unet'])}
    tbatch = {k: _t(v) for k, v in batch.items()}

    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        with pltpu.force_tpu_interpret_mode():
            jstate, jm_ = jfn(jstate, frozen, batch, key)
        draws = _jax_draws(key, batch['latents'].shape[len(lead):], accum, lo, hi or 1000)
        tstate, tm_ = tfn(tstate, tfrozen, tbatch, draws=draws)
        for m in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(tm_[m]), float(jm_[m]), rtol=1e-4)
    assert tstate.step == 2
    trees = [('pack', jstate.pack, tstate.pack)]
    if use_ema:
        trees.append(('ema', jstate.ema, tstate.ema))
    for _, jtree, ttree in trees:
        jb = lora_overlay_from_params(_numpy_tree(jtree['lora_unet']), tm)
        for path, e in ttree['lora_unet'].items():
            for leaf in ('down', 'up', 'alpha'):
                np.testing.assert_allclose(e[leaf].detach().numpy(), jb[path][leaf].numpy(),
                                           atol=2e-6)
    up = tstate.pack['lora_unet'][next(iter(pack['lora_unet']))]['up']
    assert float(up.detach().abs().max()) > 0     # the factors did move


@pytest.mark.parametrize('fused', [False, True])
def test_remat_gives_the_same_gradients(unet_pair, monkeypatch, fused):
    """(h) whole-block remat recomputes each block in the backward (the
    GroupNorms run again) and gives the same LoRA gradients, in both UNet
    configurations (the fused one reads its weights at call time, so the
    recompute sees the merged LoRA weights)."""
    _, params = unet_pair
    tte = _clip_pair()[2]
    calls = []
    real_gn = tlayers.group_norm_silu
    monkeypatch.setattr(tlayers, 'group_norm_silu',
                        lambda *a, **kw: calls.append(1) or real_gn(*a, **kw))
    rng = np.random.default_rng(36)
    x = _t(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    t = torch.tensor([10, 700])
    with torch.no_grad():
        ctx = tte(_t(rng.integers(0, 1000, (2, 77))))[0]
    grads, counts = [], []
    for remat in (False, True):
        tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny(), remat=remat,
                                               fused_sublayers=fused),
                         params).requires_grad_(False)
        ov, scales = tov.make_lora_overlay(torch.Generator().manual_seed(1), tm,
                                           [{'layers': PATTERNS, 'rank': 4}])
        gen = torch.Generator().manual_seed(2)
        for e in ov.values():
            e['up'].normal_(0.0, 0.1, generator=gen)
        leaves = tstep.pack_leaves(ov)
        for leaf in leaves:
            leaf.requires_grad_(True)
        calls.clear()
        out = make_unet_apply(tm)(assemble(lora_base_weights(tm, ov), {'lora_unet': ov}),
                                  x, t, ctx)
        out.square().mean().backward()
        counts.append(len(calls))
        grads.append([leaf.grad for leaf in leaves])
    assert counts[1] > counts[0]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
