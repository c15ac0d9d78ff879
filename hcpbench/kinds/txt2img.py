"""The ``txt2img`` traffic kind: a closed loop of
``DiffusionPipeline.txt2img`` requests from one client.

Every request of a run is drawn from the run's seed: a batch of prompts of
``prompt_tokens`` letters (each letter one token of the byte-level
tokenizer, so every prompt fills the 77-token window), short negative
prompts, and the seed of the initial noise. Every request has the same
shapes, so every seed gives the same work.

What the timed path produces is kept for the check: the text encoders'
context, the first UNet call's first transformer block, its self-attention
sublayer and the call's output, the final latents (the decode's input) and
the images on the host. After the window the program is freed and the plain
fp32 reference (``hcpbench/reference``) reruns ``check_images`` images of
one completed request, both drawn from the seed, from the same prompts,
noise and weights.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hcpbench import weights
from hcpbench.counts.model import txt2img_request
from hcpbench.trace import Ranges


@dataclasses.dataclass
class Request:
    prompts: List[str]
    negatives: List[str]
    noise_seed: int


def _words(rng: np.random.Generator, letters: int, lo: int, hi: int) -> str:
    """Lowercase words of lo..hi letters, ``letters`` letters in all."""
    out, n = [], 0
    while n < letters:
        k = min(int(rng.integers(lo, hi + 1)), letters - n)
        out.append(''.join(chr(97 + c) for c in rng.integers(0, 26, k)))
        n += k
    return ' '.join(out)


def make_request(traffic: dict, seed: int, index: int) -> Request:
    """Request ``index`` of the run seeded ``seed`` (-1: the warm-up's)."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, index + 1])
    lo, hi = traffic['word_letters']
    nlo, nhi = traffic['negative_tokens']
    B = traffic['batch']
    prompts = [_words(rng, traffic['prompt_tokens'], lo, hi) for _ in range(B)]
    negatives = [_words(rng, int(rng.integers(nlo, nhi + 1)), lo, hi) for _ in range(B)]
    return Request(prompts, negatives, int(rng.integers(0, 2 ** 63 - 1)))


def check_rows(traffic: dict, seed: int, index: int) -> List[int]:
    """The images of request ``index`` that the check compares, drawn from
    the seed; only their outputs are kept."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, index + 1, 1])
    return sorted(int(r) for r in rng.choice(traffic['batch'], traffic['check_images'],
                                             replace=False))


def first_block(config: dict) -> str:
    """The first transformer block of the UNet's down path. Its output
    (``block0``) and its self-attention sublayer's, residual included
    (``attn1``), in the first UNet call of a request are compared: few bf16
    roundings lie upstream of them, and none of the text encoders' for
    ``attn1``, so the int8 route's error in the transformer's products is
    not drowned in them."""
    level = config['unet']['down_block_types'].index('CrossAttnDownBlock2D')
    return f'down_{level}_attn_0.transformer_blocks_0'


def initial_noise(traffic: dict, config: dict, req: Request) -> torch.Tensor:
    """The request's initial latents, drawn on the CPU from its seed as the
    program draws them."""
    scale = 2 ** (len(config['vae']['block_out_channels']) - 1)
    shape = (traffic['batch'], traffic['height'] // scale, traffic['width'] // scale,
             config['vae']['latent_channels'])
    return torch.randn(shape, generator=torch.Generator().manual_seed(req.noise_seed))


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_pipeline(config: dict, seed: int, device: torch.device, int8: bool = False):
    """The program's pipeline at the configuration's widths, weights drawn
    from ``seed`` in the served dtype, channels_last, eval mode."""
    from hcpdiff_tpu_torch.infer.pipeline import DiffusionPipeline
    from hcpdiff_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from hcpdiff_tpu_torch.models.compose.sdxl_te import SDXLTextEncoderFrontend
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer
    dtype = getattr(torch, config['dtype'])

    def made(name, factory, cast):
        with torch.device('meta'):
            m = factory()
        m = cast(m.to_empty(device=device))
        weights.fill(m, seed, name, dtype)
        return m.to(memory_format=torch.channels_last).eval().requires_grad_(False)
    unet = made('unet', lambda: UNet2DCondition(UNetConfig(**_tuples(config['unet'])),
                                                int8=int8),
                lambda m: m.to_compute_dtype(dtype))
    vae = made('vae', lambda: AutoencoderKL(VAEConfig(**_tuples(config['vae']))),
               lambda m: m.to(dtype))
    encoders = [made(f'text_encoder_{i}', lambda t=t: CLIPTextModel(CLIPTextConfig(**t)),
                     lambda m: m.to(dtype))
                for i, t in enumerate(config['text_encoders'])]
    tok = CLIPTokenizer.tiny()
    if len(encoders) == 2:
        te = SDXLTextEncoderFrontend(tok, *encoders, clip_skip=config['text_layer'],
                                     clip_final_norm=False)
    else:
        te = TextEncoderFrontend(tok, encoders[0], clip_skip=config['text_layer'])
    return DiffusionPipeline(unet, vae, te)


def build_reference(config: dict, seed: int, device: torch.device):
    """(unet, vae, encoders) of the fp32 reference, the same draw."""
    from hcpbench.reference.models import UNet, VAE, CLIPText
    dtype = getattr(torch, config['dtype'])

    def made(name, factory):
        with torch.device('meta'):
            m = factory()
        m = weights.fill(m.to_empty(device=device), seed, name, dtype)
        return m.to(memory_format=torch.channels_last).eval().requires_grad_(False)
    return (made('unet', lambda: UNet(config['unet'])), made('vae', lambda: VAE(config['vae'])),
            [made(f'text_encoder_{i}', lambda t=t: CLIPText(t))
             for i, t in enumerate(config['text_encoders'])])


def reference_request(ref, config: dict, traffic: dict, req: Request, rows: List[int],
                      device: torch.device):
    """The reference's context, first transformer block, its self-attention
    sublayer and the UNet's outputs in the first call, final latents and
    images, for the given rows."""
    from hcpbench.reference.txt2img import txt2img
    unet, vae, encoders = ref
    noise = initial_noise(traffic, config, req)[rows]
    block, attn = [], []
    name = first_block(config)
    hooks = [unet.get_submodule(name).register_forward_hook(
                 lambda m, a, o: block.append(o) if not block else None),
             unet.get_submodule(name + '.attn1').register_forward_hook(
                 lambda m, a, o: attn.append(o) if not attn else None)]
    try:
        out = txt2img(unet, vae, encoders, [req.prompts[r] for r in rows],
                      [req.negatives[r] for r in rows], noise.to(device), traffic['steps'],
                      traffic['guidance'], traffic['width'], config['text_layer'],
                      config['unet'].get('addition_embed_type') == 'text_time')
    finally:
        for h in hooks:
            h.remove()
    return dict(zip(('ctx', 'eps0', 'latents', 'images'), out), block0=block[0], attn1=attn[0])


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


CHECKS = ('ctx_rel', 'attn1_rel', 'block0_rel', 'eps0_rel', 'latent_rel', 'image_rmse')


def compare(program: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared for one request's checked images (each the
    larger the worse; inf where the program's output has another shape)."""
    out = {}
    for key in ('ctx', 'attn1', 'block0', 'eps0', 'latents'):
        a, b = torch.as_tensor(program[key]), ref[key]
        out[key.replace('latents', 'latent') + '_rel'] = (
            rel(a, b) if a.shape == b.shape else float('inf'))
    a, b = torch.as_tensor(program['images']).double(), ref['images'].double().cpu()
    out['image_rmse'] = (float((a - b).square().mean().sqrt()) if a.shape == b.shape
                         else float('inf'))
    return out


class Session:
    """The program built from the configuration, and its requests."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 phases: Dict[str, float], int8: bool = False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = time.perf_counter()
        import hcpdiff_tpu_torch.infer.pipeline  # noqa: F401
        phases['import_program_s'] = time.perf_counter() - t
        if device.type == 'cuda':
            t = time.perf_counter()
            from hcpdiff_tpu_torch.ops import _build
            _build.library()
            phases['kernel_library_s'] = time.perf_counter() - t
        t = time.perf_counter()
        self.pipe = build_pipeline(config, seed, device, int8)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        phases['weights_s'] = time.perf_counter() - t
        self.kept: Dict[int, dict] = {}
        self._capture: Optional[dict] = None
        self._install_capture()

    # ---- what the check compares, kept from the timed path ----
    def _install_capture(self):
        pipe = self.pipe
        encode, decode = pipe.encode_prompts, pipe.decode

        def encode_prompts(*a, **k):
            out = encode(*a, **k)
            if self._capture is not None:
                self._capture['ctx'] = out[0]
            return out

        def decode_kept(latents):
            if self._capture is not None:
                self._capture['latents'] = latents
            return decode(latents)

        def first(key):
            def hook(module, args, output):
                if self._capture is not None and key not in self._capture:
                    self._capture[key] = output
            return hook
        pipe.encode_prompts, pipe.decode = encode_prompts, decode_kept
        pipe.unet.register_forward_hook(first('eps0'))
        block = pipe.unet.get_submodule(first_block(self.config))
        block.register_forward_hook(first('block0'))
        block.attn1.register_forward_hook(first('attn1'))

    def request(self, index: int) -> Request:
        return make_request(self.traffic, self.seed, index)

    def _call(self, req: Request):
        tr = self.traffic
        return self.pipe.txt2img(req.prompts, req.negatives, width=tr['width'],
                                 height=tr['height'], num_steps=tr['steps'],
                                 guidance_scale=tr['guidance'], sampler=tr['sampler'],
                                 seed=req.noise_seed, batch_size=tr['batch'])

    def warm(self) -> None:
        """The warm-up requests, of the window's shapes, not kept."""
        for i in range(self.traffic['warmup_requests']):
            self._call(make_request(self.traffic, self.seed, -1 - i))

    def unit(self, index: int) -> int:
        """Request ``index``; returns its images. Of what the check compares,
        the checked images' rows are kept (copies; for the doubled batch the
        negative and the positive row of each)."""
        self._capture = cap = {}
        try:
            images = self._call(self.request(index))
        finally:
            self._capture = None
        B = self.traffic['batch']
        rows = check_rows(self.traffic, self.seed, index)
        both = rows + [B + r for r in rows]

        def take(t, idx):       # an output of another batch is kept whole
            return t[idx] if t.shape[0] == (2 * B if idx is both else B) else t
        self.kept[index] = {'ctx': take(cap['ctx'], both), 'attn1': take(cap['attn1'], both),
                            'block0': take(cap['block0'], both),
                            'eps0': take(cap['eps0'], both),
                            'latents': take(cap['latents'], rows),
                            'images': take(images, rows)}
        return B

    def unit_flops(self) -> float:
        """Model operations of one unit of work, an image."""
        return txt2img_request(self.config, self.traffic) / self.traffic['batch']

    # ---- traced run: host ranges (profiled) and host timings (observed) ----
    def ranges(self):
        """Wrappers that open the benchmark's ranges around the pipeline's
        layers: the request, text encoding, each denoise step, UNet call and
        sampler step, the decode and the VAE inside it."""
        from hcpdiff_tpu_torch.diffusion import samplers
        from hcpdiff_tpu_torch.infer.pipeline import DenoiseLoop
        return _Patches(self, [
            (self.pipe, 'encode_prompts', 'hcpbench.text_encode'),
            (self.pipe, 'decode', 'hcpbench.decode'),
            (self.pipe.vae, 'decode', 'hcpbench.vae_decode'),
            (self.pipe, 'txt2img', 'hcpbench.request'),
            (DenoiseLoop, 'step', 'hcpbench.denoise_step'),
            (samplers.DPMpp2MSampler, 'step', 'hcpbench.sampler_step'),
        ], unet_range='hcpbench.unet')

    def observe(self, spans: Dict[str, list]):
        """Host timings for the per-layer metrics: each UNet call's host
        milliseconds until it returns (no synchronise), and each VAE decode's
        seconds between two synchronises."""
        return _Observe(self, spans)

    def finish(self) -> dict:
        """Free the program; the kept outputs, moved to the host."""
        kept = {i: {k: (v.detach().float().cpu() if torch.is_tensor(v) else v)
                    for k, v in rec.items()} for i, rec in self.kept.items()}
        self.pipe = self.kept = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        return kept


class _Patches:
    """Context manager: each (owner, attribute) wrapped in a range; the UNet
    in a range by forward hooks."""

    def __init__(self, session: Session, targets, unet_range: str):
        self.session, self.targets, self.unet_range = session, targets, unet_range

    def __enter__(self):
        self.saved = []
        for owner, attr, name in self.targets:
            orig = owner.__dict__.get(attr) if isinstance(owner, type) else getattr(owner, attr)
            fn = getattr(owner, attr)

            def wrapped(*a, _fn=fn, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)
            setattr(owner, attr, wrapped)
            self.saved.append((owner, attr, orig))
        ranges = Ranges()
        unet = self.session.pipe.unet
        self.hooks = [unet.register_forward_pre_hook(lambda m, a: ranges.enter(self.unet_range)),
                      unet.register_forward_hook(lambda m, a, o: ranges.exit(self.unet_range))]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)
        return False


class _Observe:
    def __init__(self, session: Session, spans: Dict[str, list]):
        self.session, self.spans = session, spans

    def __enter__(self):
        unet, vae = self.session.pipe.unet, self.session.pipe.vae
        calls = self.spans.setdefault('unet_host_ms', [])
        decodes = self.spans.setdefault('vae_decode_s', [])
        started = []

        def pre(m, a):
            started.append(time.perf_counter())

        def post(m, a, o):
            calls.append((time.perf_counter() - started.pop()) * 1e3)
        self.hooks = [unet.register_forward_pre_hook(pre), unet.register_forward_hook(post)]
        self.decode = vae.decode

        def timed_decode(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.decode(*a, **k)
            torch.cuda.synchronize()
            decodes.append(time.perf_counter() - t)
            return out
        if self.session.device.type == 'cuda':
            vae.decode = timed_decode
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        if 'decode' in self.session.pipe.vae.__dict__:
            del self.session.pipe.vae.decode
        return False


def end_to_end(records: List[dict], window_s: float) -> Dict[str, float]:
    """images_per_s: the images of the completed requests over the window;
    request_s_p95: the nearest-rank 95th percentile of every request's
    seconds."""
    done = [r for r in records if r['ok']]
    secs = sorted(r['end'] - r['start'] for r in records)
    p95 = secs[max(0, -(-95 * len(secs) // 100) - 1)] if secs else float('nan')
    return {'images_per_s': sum(r['units'] for r in done) / window_s, 'request_s_p95': p95}


def check(session_kept: dict, config: dict, traffic: dict, seed: int, device: torch.device,
          limits: dict) -> List[tuple]:
    """(name, value, limit) of each number compared: one completed request,
    drawn from the seed, its ``check_images`` checked images rerun by the
    reference."""
    done = sorted(session_kept)
    if not done:
        return [('completed_requests', 0.0, None)]
    index = int(np.random.default_rng([int(seed) % 2 ** 64, 0]).choice(done))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t = time.perf_counter()
        ref = build_reference(config, seed, device)
        built = time.perf_counter() - t
        got = compare(session_kept[index],
                      reference_request(ref, config, traffic, make_request(traffic, seed, index),
                                        check_rows(traffic, seed, index), device))
        print(f'hcpbench: reference of request {index}: build {built:.3f} s, run '
              f'{time.perf_counter() - t - built:.3f} s', file=sys.stderr)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return [(k, got[k], limits.get(k)) for k in CHECKS]
