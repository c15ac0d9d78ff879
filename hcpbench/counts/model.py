"""Model operations counted from a configuration's shapes: every
convolution, linear layer and attention product (2 operations a
multiply-add) of the text encoders, the UNet and the VAE decoder. Norms,
activations and the sampler's element-wise work are not counted.
"""
from __future__ import annotations

from .attention import pairs


def conv(B, H, W, cin, cout, k=3):
    return 2 * B * H * W * cin * cout * k * k


def linear(tokens, fin, fout):
    return 2 * tokens * fin * fout


def resblock(B, H, W, cin, cout, tdim):
    n = conv(B, H, W, cin, cout) + linear(B, tdim, cout) + conv(B, H, W, cout, cout)
    return n + (conv(B, H, W, cin, cout, 1) if cin != cout else 0)


def transformer(B, H, W, ch, depth, ctx_len, ctx_dim):
    T, S = B * H * W, H * W
    block = (4 * linear(T, ch, ch) + 4 * B * S * S * ch                   # self-attention
             + 2 * linear(T, ch, ch) + 2 * linear(B * ctx_len, ctx_dim, ch)
             + 4 * B * S * ctx_len * ch                                 # cross-attention
             + linear(T, ch, 8 * ch) + linear(T, 4 * ch, ch))           # GEGLU feed-forward
    return 2 * linear(T, ch, ch) + depth * block


def unet_call(u: dict, B: int, h: int, w: int, ctx_len: int) -> int:
    """One UNet call on B rows of an h x w latent."""
    chans = u['block_out_channels']
    ch0, n, tdim = chans[0], len(chans), chans[0] * 4
    total = linear(B, ch0, tdim) + linear(B, tdim, tdim) + conv(B, h, w, u['in_channels'], ch0)
    if u.get('addition_embed_type') == 'text_time':
        total += linear(B, u['projection_class_embeddings_input_dim'], tdim) + linear(B, tdim, tdim)

    def tfm(level, H, W, ch):
        return transformer(B, H, W, ch, u['transformer_layers_per_block'][level], ctx_len,
                           u['cross_attention_dim'])
    skip, cur, H, W = [ch0], ch0, h, w
    for bi, (kind, out_c) in enumerate(zip(u['down_block_types'], chans)):
        for _ in range(u['layers_per_block']):
            total += resblock(B, H, W, cur, out_c, tdim)
            cur = out_c
            if kind == 'CrossAttnDownBlock2D':
                total += tfm(bi, H, W, cur)
            skip.append(cur)
        if bi < n - 1:
            H, W = H // 2, W // 2
            total += conv(B, H, W, cur, cur)
            skip.append(cur)
    total += 2 * resblock(B, H, W, cur, cur, tdim) + tfm(n - 1, H, W, cur)
    for bi, kind in enumerate(u['up_block_types']):
        out_c = chans[n - 1 - bi]
        for _ in range(u['layers_per_block'] + 1):
            total += resblock(B, H, W, cur + skip.pop(), out_c, tdim)
            cur = out_c
            if kind == 'CrossAttnUpBlock2D':
                total += tfm(n - 1 - bi, H, W, cur)
        if bi < n - 1:
            H, W = H * 2, W * 2
            total += conv(B, H, W, cur, cur)
    return total + conv(B, H, W, cur, u['out_channels'])


def vae_decode(v: dict, B: int, h: int, w: int) -> int:
    """The decoder on B latents of h x w, post_quant_conv included."""
    chans, lpb = v['block_out_channels'], v['layers_per_block']
    lat, cur, H, W = v['latent_channels'], chans[-1], h, w
    S = H * W
    total = conv(B, H, W, lat, lat, 1) + conv(B, H, W, lat, cur)
    total += 2 * resblock(B, H, W, cur, cur, 0) + 4 * linear(B * S, cur, cur) + 4 * B * S * S * cur
    for bi, out_c in enumerate(reversed(chans)):
        for _ in range(lpb + 1):
            total += resblock(B, H, W, cur, out_c, 0)
            cur = out_c
        if bi < len(chans) - 1:
            H, W = H * 2, W * 2
            total += conv(B, H, W, cur, cur)
    return total + conv(B, H, W, cur, v['out_channels'])


def clip_encode(t: dict, B: int, S: int) -> int:
    """One text encoder on B sequences of S tokens (causal attention),
    the pooled projection included."""
    d, inter, L = t['hidden_size'], t['intermediate_size'], t['num_hidden_layers']
    layer = (4 * linear(B * S, d, d) + 2 * 2 * B * pairs(S, S, True) * d
             + 2 * linear(B * S, d, inter))
    return L * layer + (linear(B, d, t['projection_dim']) if t.get('projection_dim') else 0)


def txt2img_request(config: dict, traffic: dict) -> int:
    """A request: the encoders on the doubled batch's prompts, ``steps``
    UNet calls on 2B rows (classifier-free guidance) and the decode."""
    B, scale = traffic['batch'], 2 ** (len(config['vae']['block_out_channels']) - 1)
    h, w = traffic['height'] // scale, traffic['width'] // scale
    rows = 2 * B if traffic['guidance'] > 1 else B
    text = sum(clip_encode(t, rows, 77) for t in config['text_encoders'])
    return (text + traffic['steps'] * unet_call(config['unet'], rows, h, w, 77)
            + vae_decode(config['vae'], B, h, w))
