"""The PyTorch port's models (hcpdiff_tpu_torch/models) against the JAX
package's, at tiny widths in fp32 on the CPU, with the same weights carried
across by the bridge (hcpdiff_tpu_torch/ckpt/bridge.py).

On the CPU the JAX models run their XLA paths and the port its kernels'
plain versions, so the tolerances bound fp32 summation-order differences
over a whole network; 5e-4 is the repo's UNet bound (test_unet_parity.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.models import clip as jclip
from hcpdiff_tpu.models import text_frontend as jtf
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.models import vae as jvae
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer
from hcpdiff_tpu_torch.ckpt.bridge import load_params, state_dict_from_params
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import text_frontend as ttf
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.models import vae as tvae
from hcpdiff_tpu_torch.utils import clip_tokenizer as ttok
from tests.torch_port_common import random_params, one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_unet_tiny_matches_jax():
    cfg = junet.UNetConfig.tiny()
    jm = junet.UNet2DCondition(cfg, dtype=jnp.float32)
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                           jnp.zeros((1, 77, cfg.cross_attention_dim)), seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    t = np.array([500, 10])
    ref = np.asarray(jax.jit(jm.apply)({'params': params}, x, t, ctx))
    tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny()), params)
    with torch.no_grad():
        out = tm(_t(x), _t(t), _t(ctx))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4)


def _vae_pair():
    jm = jvae.AutoencoderKL(jvae.VAEConfig.tiny(), dtype=jnp.float32)
    params = random_params(jm, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0), seed=2)
    return jm, params, load_params(tvae.AutoencoderKL(tvae.VAEConfig.tiny()), params)


def test_vae_tiny_decode_matches_jax():
    jm, params, tm = _vae_pair()
    z = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z: jm.apply({'params': p}, z, method='decode'))(params, z))
    with torch.no_grad():
        out = tm.decode(_t(z))
    assert out.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_vae_tiny_encode_matches_jax():
    jm, params, tm = _vae_pair()
    img = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: jm.apply({'params': p}, x, method='encode'))(params, img)
    with torch.no_grad():
        tmean, tlogvar = tm.encode(_t(img))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), atol=1e-4)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar), atol=1e-4)


def _tokenizer():
    return CLIPTokenizer.tiny(words=('a', 'cat', 'photo', 'of'))


@pytest.mark.parametrize('words', [(), ('a', 'cat', 'photo', 'of')])
def test_tokenizer_copy_gives_the_same_ids(words):
    """The port's copy of the tokenizer against the JAX package's: the
    padded call, windows, bare ids and decode, with emphasis syntax, a
    prompt over 77 tokens and a trigger word added to both."""
    ref, tok = CLIPTokenizer.tiny(words=words), ttok.CLIPTokenizer.tiny(words=words)
    assert (tok.bos_token_id, tok.eos_token_id, tok.vocab_size) == (
        ref.bos_token_id, ref.eos_token_id, ref.vocab_size)
    assert tok.add_word('sks', 2) == ref.add_word('sks', 2)
    prompts = ['a photo of a {cat:1.3}', '{a {cat}} , sks photo', 'a cat ' * 60, '']
    assert tok(prompts) == ref(prompts)
    for p in prompts:
        assert tok.tokenize_words(p) == ref.tokenize_words(p)
        assert tok.encode_windows(p, n_repeats=2) == ref.encode_windows(p, n_repeats=2)
        ids = ref.tokenize_words(p)
        assert tok.decode(ids) == ref.decode(ids)


def _clip_pair(tk):
    jcfg = jclip.CLIPTextConfig.tiny(bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    jm = jclip.CLIPTextModel(jcfg)
    params = random_params(jm, jnp.zeros((1, 77), jnp.int32), seed=5)
    tcfg = dataclasses.replace(tclip.CLIPTextConfig.tiny(), bos_token_id=tk.bos_token_id,
                               eos_token_id=tk.eos_token_id)
    return jm, params, load_params(tclip.CLIPTextModel(tcfg), params)


def test_clip_tiny_matches_jax():
    tk = _tokenizer()
    jm, params, tm = _clip_pair(tk)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 1000, (2, 77))
    ids[:, 20] = tk.eos_token_id
    mult = rng.uniform(0.5, 1.5, (2, 77)).astype(np.float32)
    last, pooled, hs = jax.jit(lambda p, i, m: jm.apply({'params': p}, i,
                                                        embedding_multiplier=m))(params, ids, mult)
    with torch.no_grad():
        tlast, tpooled, ths = tm(_t(ids), embedding_multiplier=_t(mult))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(last), atol=1e-5)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=1e-5)
    assert len(ths) == len(hs)
    for a, b in zip(ths, hs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize('n_repeats,clip_skip', [(1, 0), (2, 1)])
def test_text_frontend_encode_matches_jax(n_repeats, clip_skip):
    """Tokenize (with {emphasis:1.3} weights), window packing and merge,
    clip_skip with the final norm."""
    tk = _tokenizer()
    jm, params, tm = _clip_pair(tk)
    prompts = ['a photo of a {cat:1.3}', '{a {cat}} ' * 12]
    jfront = jtf.TextEncoderFrontend(tk, jm, params, n_repeats=n_repeats, clip_skip=clip_skip)
    tfront = ttf.TextEncoderFrontend(tk, tm, n_repeats=n_repeats, clip_skip=clip_skip)
    assert ttf.parse_attn_mult(prompts[1]) == jtf.parse_attn_mult(prompts[1])
    hidden, pooled = jfront.encode(prompts)
    thidden, tpooled = tfront.encode(prompts)
    assert thidden.shape == (2, n_repeats * 75 + 2, 32)
    np.testing.assert_allclose(thidden.numpy(), np.asarray(hidden), atol=1e-5)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=1e-5)


def test_bridge_layouts_and_strict_names():
    """Conv HWIO -> OIHW, dense [in,out] -> [out,in], scale -> weight; a
    tree that does not match the module's names fails to load."""
    k4 = np.arange(3 * 3 * 2 * 5, dtype=np.float32).reshape(3, 3, 2, 5)
    k2 = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd = state_dict_from_params({'c': {'kernel': k4, 'bias': np.zeros(5)},
                                 'd': {'kernel': k2}, 'n': {'scale': np.ones(4)}})
    assert sd['c.weight'].shape == (5, 2, 3, 3)
    assert sd['c.weight'][4, 1, 2, 0] == k4[2, 0, 1, 4]
    assert torch.equal(sd['d.weight'], torch.from_numpy(k2.T.copy()))
    assert set(sd) == {'c.weight', 'c.bias', 'd.weight', 'n.weight'}
    with pytest.raises(RuntimeError):
        load_params(torch.nn.Linear(3, 2), {'kernel': np.zeros((3, 2), np.float32)})
