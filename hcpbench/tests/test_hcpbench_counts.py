"""The count functions against hand-worked shapes, and the model count
against the operations PyTorch's FLOP counter sees in the plain reference
at tiny widths."""
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hcpbench.counts import attention, gemm, model
from hcpbench.reference.models import CLIPText, UNet, VAE
from hcpbench.tests.tiny import DATA

HERE = Path(__file__).resolve().parents[1]


def t(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device='meta')


def test_attention_forward_hand_worked():
    # SD1.5's 64x64 self-attention at batch 16: 8 heads of 40
    q = k = v = t(16, 8, 4096, 40)
    flops, nbytes, dtype = attention.forward(q, k, v)
    assert flops == 4 * 16 * 8 * 4096 * 4096 * 40
    assert nbytes == 4 * 16 * 8 * 4096 * 40 * 2
    assert dtype == torch.bfloat16
    # cross-attention over 77 keys of another width
    flops, nbytes, _ = attention.forward(t(2, 8, 1024, 80), t(2, 8, 77, 80), t(2, 8, 77, 80))
    assert flops == 2 * 2 * 8 * 1024 * 77 * (80 + 80)
    assert nbytes == 2 * 8 * (1024 * 80 * 2 + 77 * 80 * 2) * 2


def test_attention_causal_and_backward():
    assert attention.pairs(4, 4, True) == 10
    assert attention.pairs(2, 4, True) == 3 + 4
    assert attention.pairs(3, 5, False) == 15
    flops, nbytes, _ = attention.backward(t(1, 2, 8, 16), t(1, 2, 8, 16), t(1, 2, 8, 16))
    assert flops == 2 * 2 * 64 * 64
    assert nbytes == 2 * (8 * 16 * 8) * 2


def g(*shape):
    return t(*shape).requires_grad_(True)


def test_gemm_backward_hand_worked():
    # SD1.5's ff.proj under LoRA at 64x64, batch 48: x and the merged weight take gradients
    M = 48 * 4096
    flops, nbytes, _ = gemm.geglu_backward(g(48, 4096, 320), g(2560, 320), g(2560))
    assert flops == 2 * 2 * M * 2560 * 320
    assert nbytes == (M * 1280 + 2 * (M * 320 + 2560 * 320) + 2560) * 2
    # proj_in: frozen weight, so dX alone (dY and W read, dX written)
    flops, nbytes, _ = gemm.dense_backward(g(48, 4096, 320), t(320, 320), t(320))
    assert flops == 2 * M * 320 * 320
    assert nbytes == (M * 320 + 320 * 320 + M * 320) * 2
    # with a residual that takes a gradient, dres = dY is written too
    _, with_res, _ = gemm.dense_backward(g(8, 320), t(320, 320), None, g(8, 320))
    _, without, _ = gemm.dense_backward(g(8, 320), t(320, 320))
    assert with_res - without == 8 * 320 * 2


def test_gemm_hand_worked():
    # SD1.5's ff.proj at 64x64, batch 16: [16, 4096, 320] x [2560, 320]^T
    x, w, b = t(16, 4096, 320), t(2560, 320), t(2560)
    flops, nbytes, _ = gemm.geglu(x, w, b)
    M = 16 * 4096
    assert flops == 2 * M * 2560 * 320
    assert nbytes == (M * 320 + 2560 * 320 + 2560 + M * 1280) * 2
    flops, nbytes, _ = gemm.dense(t(M, 1280), t(320, 1280), t(320), t(M, 320))
    assert flops == 2 * M * 320 * 1280
    assert nbytes == (M * 1280 + 320 * 1280 + 320 + 2 * M * 320) * 2


def counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize('name', ['tiny', 'tiny_xl'])
def test_model_counts_match_flop_counter(name):
    cfg = json.loads((DATA / f'{name}.json').read_text())
    B, h, S = 2, 8, 77
    unet = UNet(cfg['unet'])
    extra = {}
    if cfg['unet'].get('addition_embed_type') == 'text_time':
        extra = {'pooled': torch.zeros(B, cfg['text_encoders'][-1]['projection_dim']),
                 'time_ids': torch.zeros(B, 6)}
    ctx = torch.zeros(B, S, cfg['unet']['cross_attention_dim'])
    assert counted(lambda: unet(torch.zeros(B, h, h, 4), torch.zeros(B), ctx, **extra)) == \
        model.unet_call(cfg['unet'], B, h, h, S)
    vae = VAE(cfg['vae'])
    assert counted(lambda: vae.decode_image(torch.zeros(B, h, h, 4))) == \
        model.vae_decode(cfg['vae'], B, h, h)
    for tc in cfg['text_encoders']:
        enc = CLIPText(tc)
        ids = torch.zeros(B, S, dtype=torch.long)
        full = counted(lambda: enc(ids, 0))
        # the counter sees the whole S x S products; the count, the causal pairs
        causal_gap = tc['num_hidden_layers'] * 2 * 2 * B * (S * S - attention.pairs(S, S, True)) \
            * tc['hidden_size']
        assert full - causal_gap == model.clip_encode(tc, B, S)


def test_sd15_image_count_beside_the_jax_figure():
    """The count of an SD1.5 512 px image (20 steps, CFG, VAE decode and the
    text encoder); PERF.md sets it beside the JAX package's 34.65 TFLOP."""
    cfg = json.loads((HERE / 'configs' / 'sd15.json').read_text())
    tr = json.loads((HERE / 'traffic' / 'txt2img-512-b16.json').read_text())
    per_image = model.txt2img_request(cfg, tr) / tr['batch']
    assert 30e12 < per_image < 40e12
