"""Faults planted in the program's timed path, to show that a cell's check
reads them as not correct. Each is a context manager that patches the
program while it is active; build the cell's session inside it. Used by the
CPU fault test (``tests/test_hcpbench_faults.py``) and by ``controls.py``,
which reads each on the card at the cell's size.

txt2img:

- ``state_unchanged``: every sampler step returns its latents unchanged;
- ``half_batch``: each UNet call computes the positive half of its
  classifier-free-guidance batch alone and returns it for both halves, the
  negative half left out;
- ``token_altered``: the tokenizer changes the first token of every prompt;
- ``answer_altered``: the decode blanks the top eighth of every image.

train:

- ``state_unchanged``: the optimizer's step leaves the parameters and its
  state as they were;
- ``half_batch``: the loss is the mean over the first half of the batch,
  the rest left out;
- ``token_altered``: the text encoder reads every sequence's first token
  changed.

The exchange between chips has no fault here: every cell takes one chip.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FAULTS = {'txt2img': ('state_unchanged', 'half_batch', 'token_altered', 'answer_altered'),
          'train': ('state_unchanged', 'half_batch', 'token_altered')}


@contextlib.contextmanager
def _patch(owner, attr, fn) -> Iterator[None]:
    orig = owner.__dict__[attr]
    setattr(owner, attr, fn(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def planted(kind: str, name: str):
    if name not in FAULTS[kind]:
        raise KeyError(f'unknown fault {name!r} of {kind} (known: {FAULTS[kind]})')
    return (_txt2img if kind == 'txt2img' else _train)(name)


def _train(name: str):
    from hcpdiff_tpu_torch.diffusion.losses import MSELoss
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend

    if name == 'state_unchanged':
        def step(orig):
            def f(self, closure=None):
                return None
            return f
        return _patch(torch.optim.AdamW, 'step', step)
    if name == 'half_batch':
        def call(orig):
            def f(self, pred, target, timesteps=None):
                h = pred.shape[0] // 2
                return orig(self, pred[:h], target[:h], timesteps)
            return f
        return _patch(MSELoss, '__call__', call)

    def encode_ids(orig):
        def f(self, input_ids, *a, **k):
            ids = input_ids.clone()
            ids[:, 1] = (ids[:, 1] + 1) % 256
            return orig(self, ids, *a, **k)
        return f
    return _patch(TextEncoderFrontend, 'encode_ids', encode_ids)


def _txt2img(name: str):
    from hcpdiff_tpu_torch.diffusion.samplers import DPMpp2MSampler
    from hcpdiff_tpu_torch.infer.pipeline import DiffusionPipeline
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition

    if name == 'state_unchanged':
        def step(orig):
            def f(self, state, model_out, i, x, generator=None):
                _, new_state, x0 = orig(self, state, model_out, i, x, generator)
                return x, new_state, x0
            return f
        return _patch(DPMpp2MSampler, 'step', step)
    if name == 'half_batch':
        def forward(orig):
            def f(self, sample, timesteps, encoder_hidden_states, **kw):
                h = sample.shape[0] // 2

                def half(v):
                    return v[h:] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * h else v
                out = orig(self, sample[h:], half(timesteps), encoder_hidden_states[h:],
                           **{k: half(v) for k, v in kw.items()})
                return torch.cat([out, out])
            return f
        return _patch(UNet2DCondition, 'forward', forward)
    if name == 'token_altered':
        def tokenize(orig):
            def f(self, text):
                enc = orig(self, text)
                enc.input_ids = enc.input_ids.copy()
                enc.input_ids[1] = (enc.input_ids[1] + 1) % 256
                return enc
            return f
        return _patch(TextEncoderFrontend, 'tokenize', tokenize)

    # answer_altered
    def decode(orig):
        def f(self, latents):
            images = orig(self, latents)
            images[:, :images.shape[1] // 8] = 0.0
            return images
        return f
    return _patch(DiffusionPipeline, 'decode', decode)
