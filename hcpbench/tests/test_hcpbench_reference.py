"""The plain reference at tiny widths on the CPU: hand-worked cases of its
parts, the same parameter names and shapes as the program's models at the
published widths, and agreement with the program in fp32."""
import json
import math

import numpy as np
import pytest
import torch

from hcpbench import weights
from hcpbench.harness import HERE
from hcpbench.reference import models
from hcpbench.reference.txt2img import ByteTokenizer, dpmpp_2m_sigmas


def test_tokenizer_by_hand():
    ids = ByteTokenizer().ids('abc de')
    # 'a'..'~' are ids 64.. ('!' is 0); a word's last byte takes its </w> form (+256)
    assert ids[:6] == [512, 64, 65, 256 + 66, 67, 256 + 68]
    assert ids[6:] == [513] * 71 and len(ids) == 77
    assert len(ByteTokenizer().ids(' '.join(['abcdefghij'] * 10))) == 77
    with pytest.raises(ValueError):
        ByteTokenizer().ids('Not the alphabet')


def test_sigmas_by_hand():
    ts, sig = dpmpp_2m_sigmas(20)
    assert ts[0] == 999 and ts[-1] == 0 and len(sig) == 21 and sig[-1] == 0
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    acp = np.cumprod(1 - betas)
    assert sig[0] == pytest.approx(math.sqrt((1 - acp[999]) / acp[999]))
    assert sig[0] == pytest.approx(14.6146, abs=1e-3)


def test_attention_by_hand():
    q = torch.tensor([[[[1.0, 0.0]]]])
    k = torch.tensor([[[[1.0, 0.0], [0.0, 1.0]]]])
    v = torch.tensor([[[[2.0, 0.0], [0.0, 4.0]]]])
    p = torch.softmax(torch.tensor([1.0, 0.0]) / math.sqrt(2), 0)
    assert torch.allclose(models.attention(q, k, v)[0, 0, 0], p[0] * v[0, 0, 0] + p[1] * v[0, 0, 1])
    causal = models.attention(k, k, v, causal=True)
    assert torch.allclose(causal[0, 0, 0], v[0, 0, 0])


@pytest.mark.parametrize('name', ['sd15', 'sdxl'])
def test_same_parameters_as_the_program(name):
    from hcpdiff_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    cfg = json.loads((HERE / 'configs' / f'{name}.json').read_text())

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    def shapes(m):
        return {n: tuple(p.shape) for n, p in m.named_parameters()}
    with torch.device('meta'):
        pairs = [(UNet2DCondition(UNetConfig(**tup(cfg['unet']))), models.UNet(cfg['unet'])),
                 (AutoencoderKL(VAEConfig(**tup(cfg['vae']))), models.VAE(cfg['vae']))]
        pairs += [(CLIPTextModel(CLIPTextConfig(**tc)), models.CLIPText(tc))
                  for tc in cfg['text_encoders']]
    for program, reference in pairs:
        assert shapes(program) == shapes(reference)


def test_weights_draw_is_seeded_and_scaled():
    lin = torch.nn.Linear(64, 32)
    a = weights.draw(lin, 2 ** 31 + 1, 'x', torch.float32, torch.device('cpu'))
    b = weights.draw(lin, 2 ** 31 + 1, 'x', torch.float32, torch.device('cpu'))
    c = weights.draw(lin, 2 ** 31 + 2, 'x', torch.float32, torch.device('cpu'))
    assert torch.equal(a['weight'], b['weight']) and not torch.equal(a['weight'], c['weight'])
    assert a['weight'].std().item() == pytest.approx(64 ** -0.5, rel=0.1)
    assert a['bias'].std().item() == pytest.approx(0.02, rel=0.5)
    ln = torch.nn.LayerNorm(256)
    w = weights.draw(ln, 1, 'y', torch.float32, torch.device('cpu'))['weight']
    assert w.mean().item() == pytest.approx(1.0, abs=0.01)
