"""The selective remat policy (``HCP_REMAT_POLICY=flash``, the JAX
package's default, ``hcpdiff_tpu/models/unet.py:630-646``) against whole-
block remat (``full``) and the JAX UNet's gradients, at tiny widths in fp32
on the CPU.

The tiny UNet runs a 32x32 latent, so its three level-0 self-attentions
(S = 1024) take the flash route: the ``_FlashAttention`` function, whose
forward with lse is the plain version on the CPU. Under ``flash`` the
recompute takes the o and lse the forward kept (``models/unet.py:remat``)
instead of running that forward again: it runs once per attention,
against twice under ``full``, and the backward reads the very lse the
forward wrote. LoRA gradients under either policy equal the
no-remat ones and the JAX UNet's (remat, its default policy) within atol
1e-6, the remat test's bound in ``test_torch_port_train.py`` (the largest
gradient is ~3.5e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.adapt import overlay as jov
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu_torch.ckpt.bridge import load_params, lora_overlay_from_params
from hcpdiff_tpu_torch.config import containerize
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.ops import flash_attention as tfa
from hcpdiff_tpu_torch.trainer.assemble import assemble, lora_base_weights, make_unet_apply
from hcpdiff_tpu_torch.trainer.step import pack_leaves
from hcpdiff_tpu_torch.trainer.trainer import Trainer
from tests.test_torch_port_trainer import _cfg, one_torch_thread, proj
from tests.torch_port_common import random_params

__all__ = ['one_torch_thread', 'proj']       # fixtures shared with the trainer file
PATTERNS = ['re:.*attn[12]\\.to_(q|k|v|out)$', 're:.*ff\\.(proj|out)$']
N_FLASH = 3                 # the tiny UNet's self-attentions at S = 1024 (32x32 latent)
CTX = 32


@pytest.fixture(scope='module')
def case():
    """Weights, LoRA factors (up factors random, so every gradient flows)
    and an input, as JAX arrays and numpy."""
    jm = junet.UNet2DCondition(junet.UNetConfig.tiny(), dtype=jnp.float32, remat=True)
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                           jnp.zeros((1, 77, CTX)), seed=60)
    overlay, scales = jov.make_lora_overlay(jax.random.PRNGKey(4), params,
                                            [{'layers': PATTERNS, 'rank': 4}])
    rng = np.random.default_rng(61)
    overlay = {p: dict(e, up=(0.1 * rng.standard_normal(np.shape(e['up']))).astype(np.float32))
               for p, e in jax.tree_util.tree_map(np.asarray, overlay).items()}
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    t = np.array([10, 700])
    ctx = rng.standard_normal((2, 77, CTX)).astype(np.float32)
    return jm, params, overlay, scales, (x, t, ctx)


def _port_grads(case, remat, policy, fused=False):
    """The port's LoRA gradients of mean(out^2), through ``make_unet_apply``
    (``functional_call`` with the merged weights, as the trainer runs)."""
    _, params, overlay, scales, (x, t, ctx) = case
    tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny(), remat=remat,
                                           fused_sublayers=fused, remat_policy=policy),
                     params).requires_grad_(False)
    ov = lora_overlay_from_params(overlay, tm)
    leaves = pack_leaves(ov)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = make_unet_apply(tm)(assemble(lora_base_weights(tm, ov), {'lora_unet': ov}),
                              *(torch.from_numpy(a) for a in (x, t, ctx)))
    out.square().mean().backward()
    return {p: {k: v.grad for k, v in e.items() if k in ('down', 'up')} for p, e in ov.items()}


def _close(a, b, atol):
    assert a.keys() == b.keys()
    for p in a:
        for k in a[p]:
            np.testing.assert_allclose(a[p][k].numpy(), np.asarray(b[p][k]), atol=atol,
                                       rtol=0, err_msg=f'{p}.{k}')


def test_policies_give_the_jax_gradients(case):
    """Both policies and no remat: the same LoRA gradients, and the JAX
    UNet's (remat under its default policy)."""
    jm, params, overlay, scales, (x, t, ctx) = case

    def loss(ov):
        merged = jov.merge_overlays(params, [ov], [scales])
        return jnp.mean(jm.apply({'params': merged}, x, t, ctx) ** 2)
    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(overlay))
    want = _port_grads(case, remat=False, policy='full')
    for policy in tunet.REMAT_POLICIES:
        _close(_port_grads(case, remat=True, policy=policy), want, atol=1e-6)
    jgrads = lora_overlay_from_params(jgrads, tunet.UNet2DCondition(tunet.UNetConfig.tiny()))
    _close(want, {p: {k: e[k] for k in ('down', 'up')} for p, e in jgrads.items()}, atol=1e-6)


def test_fused_unet_policies_give_the_same_gradients(case):
    """Kernels G-J's autograd functions (plain versions here) under the
    ``flash`` policy: recomputed, with the attention's o and lse kept."""
    want = _port_grads(case, remat=False, policy='full', fused=True)
    for policy in tunet.REMAT_POLICIES:
        _close(_port_grads(case, remat=True, policy=policy, fused=True), want, atol=1e-6)


@pytest.mark.parametrize('remat, policy, runs', [(False, 'flash', N_FLASH),
                                                 (True, 'flash', N_FLASH),
                                                 (True, 'full', 2 * N_FLASH)])
def test_forward_with_lse_runs_once_an_attention_under_flash(case, monkeypatch, remat, policy,
                                                             runs):
    """The forward with lse counted on the CPU (its lse is the plain
    logsumexp): once per attention a step under ``flash``, where the
    recompute takes the kept o and lse, twice under ``full``; the lse
    kernel E reads in each backward is one a forward wrote (the same
    storage)."""
    written, read = [], []
    lse_plain, bwd_dq = tfa.attention_lse_plain, tfa.flash_attention_bwd_dq

    def counted_lse(q, k, scale, causal=False):
        written.append(lse_plain(q, k, scale, causal))
        return written[-1]

    def recorded_dq(q, k, v, lse, *rest):
        read.append(lse.untyped_storage().data_ptr())
        return bwd_dq(q, k, v, lse, *rest)
    monkeypatch.setattr(tfa, 'attention_lse_plain', counted_lse)
    monkeypatch.setattr(tfa, 'flash_attention_bwd_dq', recorded_dq)
    _port_grads(case, remat=remat, policy=policy)
    assert len(written) == runs and len(read) == N_FLASH
    assert set(read) <= {t.untyped_storage().data_ptr() for t in written}


def test_trainer_builds_the_flash_policy_by_default(proj, tmp_path, monkeypatch):
    cfg = _cfg(proj, tmp_path / 'exp', device='cpu',
               **{'model.gradient_checkpointing': True, 'train.train_steps': 1,
                  'data.dataset1.cache_latents': False,
                  'lora_unet': [{'lr': 1e-3, 'rank': 2, 'layers': ['re:.*\\.attn.?$']}]})
    monkeypatch.delenv('HCP_REMAT_POLICY', raising=False)
    trainer = Trainer(containerize(cfg))
    assert trainer.unet.remat and trainer.unet.remat_policy == 'flash'
    monkeypatch.setenv('HCP_REMAT_POLICY', 'full')
    assert Trainer(containerize(cfg)).unet.remat_policy == 'full'
    monkeypatch.setenv('HCP_REMAT_POLICY', 'some')
    with pytest.raises(ValueError, match='HCP_REMAT_POLICY'):
        Trainer(containerize(cfg))
