"""Datasets, the epoch loop and DataGroup (counterpart of
``hcpdiff_tpu/data/dataset.py``).

Host-side and deterministic given (epoch, step): the bucket picks the
batch's (w, h); the dataset loads, crops and tokenizes with the JAX
package's numpy seeds, so both packages give the same batches. Batches
stay numpy until the trainer moves them to the device.

- ``cache_latents`` encodes every (image, bucket size) once through the
  VAE before training (optionally persisted as the same
  ``latents_<md5>.npz`` file), so the loop never runs the VAE;
- ``CycleData`` re-shuffles the buckets each epoch and can start at an
  (epoch, batch) position, which is how a resumed run continues the data
  where the saved one stopped;
- ``DataGroup`` zips several datasets (DreamBooth's instance and class
  images), one batch of each a step, on a prefetch thread.

Not ported: DreamArtist's [neg, pos] prompt layout, ControlNet condition
images and SDXL crop-info ``time_ids`` (the trainer refuses their
configs, ROADMAP.md queue 1 items 6 and 7).
"""
from __future__ import annotations

import hashlib
import os
import queue as queue_mod
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.images import resize_bicubic
from .buckets import BaseBucket, FixedBucket
from .sources import DataSource, Text2ImageAttMapSource
from .utils import resize_crop_fix, to_model_input


class TextImagePairDataset:
    def __init__(self, source: DataSource, bucket: Optional[BaseBucket] = None,
                 frontend=None, vae_scale: int = 8,
                 cache_latents: bool = False, cache_dir: Optional[str] = None,
                 loss_weight: float = 1.0):
        self.source = source
        self.bucket = FixedBucket(512) if bucket is None else bucket
        self.frontend = frontend
        self.vae_scale = vae_scale
        self.want_cache = cache_latents
        self.cache_dir = cache_dir
        self.loss_weight = float(loss_weight)
        self._latent_cache: Dict[Any, np.ndarray] = {}
        self.files: List[Tuple[str, Dict[str, Any]]] = []
        self.encodes: List[Tuple[int, Tuple[int, int]]] = []   # (images, size) of each call

    # ---- build ----
    def build(self, bs: int) -> 'TextImagePairDataset':
        self.bs = bs
        self.files = self.source.get_image_list()
        infos = [(p, self.source.size_of(p)) for p, _ in self.files]
        self.bucket.build(infos, bs)
        return self

    def __len__(self) -> int:
        return len(self.bucket)

    # ---- latent caching ----
    def _cache_key(self) -> str:
        return hashlib.md5(str([p for p, _ in self.files]).encode()).hexdigest()[:12]

    def cache_all_latents(self, encode_fn: Callable[[np.ndarray], np.ndarray],
                          batch_size: int = 8) -> None:
        """encode_fn: [N, H, W, 3] in [-1, 1] -> [N, h, w, 4] scaled latents.
        One entry per (item, bucket size), from the centre crop; the
        encodes go in the bucket's batch order, up to ``batch_size`` new
        items a call."""
        for bi in range(len(self.bucket)):
            idx, size = self.bucket[bi]
            for start in range(0, len(idx), batch_size):
                chunk = [i for i in idx[start:start + batch_size]
                         if (int(i), size) not in self._latent_cache]
                chunk = list(dict.fromkeys(int(i) for i in chunk))
                if not chunk:
                    continue
                imgs = [self._load_image(i, size, rng=None)[0] for i in chunk]
                lat = np.asarray(encode_fn(np.stack(imgs)))
                self.encodes.append((len(chunk), size))
                for i, l in zip(chunk, lat):
                    self._latent_cache[(i, size)] = l
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            np.savez(os.path.join(self.cache_dir, f'latents_{self._cache_key()}.npz'),
                     **{f'{i}_{s[0]}x{s[1]}': v for (i, s), v in self._latent_cache.items()})

    def load_latent_cache(self) -> bool:
        if not self.cache_dir:
            return False
        path = os.path.join(self.cache_dir, f'latents_{self._cache_key()}.npz')
        if not os.path.exists(path):
            return False
        z = np.load(path)
        for k in z.files:
            i, wh = k.rsplit('_', 1)
            w, h = wh.split('x')
            self._latent_cache[(int(i), (int(w), int(h)))] = z[k]
        return True

    # ---- item assembly ----
    def _load_image(self, i: int, size: Tuple[int, int],
                    rng: Optional[np.random.Generator]) -> Tuple[np.ndarray, dict]:
        path, meta = self.files[i]
        src = meta.get('source', self.source)
        img, crop_info = resize_crop_fix(src.load_image(path), size, rng)
        return to_model_input(img), crop_info

    def get_batch(self, bi: int, epoch: int = 0, step_seed: int = 0) -> Dict[str, np.ndarray]:
        idx, size = self.bucket[bi]
        rng = np.random.default_rng((epoch * 1_000_003 + step_seed * 7919 + bi))
        w, h = size
        lw, lh = w // self.vae_scale, h // self.vae_scale

        latents, images, prompts, att_masks = [], [], [], []
        for i in idx:
            i = int(i)
            path, meta = self.files[i]
            src = meta.get('source', self.source)
            cached = self._latent_cache.get((i, size))
            if cached is not None:
                latents.append(cached)
            else:
                images.append(self._load_image(i, size, rng)[0])
            if hasattr(src, 'make_prompt'):
                pr = (src.make_prompt(path, rng) if 'class_word' not in meta
                      else src.make_prompt(path, rng, meta.get('class_word')))
            else:
                pr = src.get_caption(path) or ''
            prompts.append(pr)
            if isinstance(src, Text2ImageAttMapSource):
                am = src.get_att_map(path)
                if am is not None:
                    att_masks.append(src.att_map_to_weight(resize_bicubic(am, (lw, lh))))

        batch: Dict[str, Any] = {'loss_weight': np.float32(self.loss_weight)}
        if latents and not images:
            batch['latents'] = np.stack(latents)
        elif images:
            batch['images'] = np.stack(images)
        if self.frontend is not None:
            flat = [p if isinstance(p, str) else p[-1] for p in prompts]
            batch['input_ids'], batch['token_mult'] = self.frontend.tokenize_batch(flat)
        else:
            batch['prompts'] = prompts
        if att_masks:
            batch['att_mask'] = np.stack(att_masks).astype(np.float32)
        return batch


class CycleData:
    """Endless epochs: ``bucket.rest(epoch)`` at each, then its batches in
    order; starts at batch ``index`` of ``epoch``."""

    def __init__(self, dataset: TextImagePairDataset, epoch: int = 0, index: int = 0):
        self.dataset = dataset
        self.epoch, self.index = epoch, index

    def __iter__(self):
        epoch, start = self.epoch, self.index
        while True:
            self.dataset.bucket.rest(epoch)
            for bi in range(start, len(self.dataset)):
                yield self.dataset.get_batch(bi, epoch=epoch, step_seed=bi)
            epoch, start = epoch + 1, 0


class DataGroup:
    """Zip N datasets, one batch from each a step, each with its own bs and
    loss weight; ``start`` gives each dataset's (epoch, batch) to begin at."""

    PREFETCH = 2

    def __init__(self, datasets: Sequence[TextImagePairDataset],
                 start: Optional[Sequence[Tuple[int, int]]] = None):
        self.datasets = list(datasets)
        self.start = list(start) if start else [(0, 0)] * len(self.datasets)

    def __iter__(self):
        iters = [iter(CycleData(d, *s)) for d, s in zip(self.datasets, self.start)]
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue_mod.Full:
                    continue

        def worker():
            try:
                while not stop.is_set():
                    put([next(it) for it in iters])
            except Exception as e:          # handed to the consumer, which raises it
                put(e)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            th.join()
