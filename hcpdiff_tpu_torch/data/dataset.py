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

- DreamArtist's collate lays the prompts out [neg..., pos...] (a prompt
  without a pair is doubled); ``with_crop_info`` adds SDXL's crop-info
  ``time_ids`` [B, 6] (``CropInfoPairDataset``).

Not ported: ControlNet condition images (the trainer refuses their
configs, ROADMAP.md queue 1 item 7).
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
                 loss_weight: float = 1.0, dream_artist: bool = False,
                 with_crop_info: bool = False):
        self.source = source
        self.bucket = FixedBucket(512) if bucket is None else bucket
        self.frontend = frontend
        self.vae_scale = vae_scale
        self.want_cache = cache_latents
        self.cache_dir = cache_dir
        self.loss_weight = float(loss_weight)
        self.dream_artist = dream_artist
        self.with_crop_info = with_crop_info
        # (i, size) -> (latent, the crop's geometry; None when read from disk)
        self._latent_cache: Dict[Any, Tuple[np.ndarray, Optional[dict]]] = {}
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
                imgs, metas = zip(*[self._load_image(i, size, rng=None) for i in chunk])
                lat = np.asarray(encode_fn(np.stack(imgs)))
                self.encodes.append((len(chunk), size))
                for i, l, ci in zip(chunk, lat, metas):
                    self._latent_cache[(i, size)] = (l, ci)
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            np.savez(os.path.join(self.cache_dir, f'latents_{self._cache_key()}.npz'),
                     **{f'{i}_{s[0]}x{s[1]}': v[0] for (i, s), v in self._latent_cache.items()})

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
            self._latent_cache[(int(i), (int(w), int(h)))] = (z[k], None)
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

        latents, images, prompts, att_masks, crop_infos = [], [], [], [], []
        for i in idx:
            i = int(i)
            path, meta = self.files[i]
            src = meta.get('source', self.source)
            cached = self._latent_cache.get((i, size))
            if cached is not None:
                latents.append(cached[0])
                crop_info = cached[1]
            else:
                img, crop_info = self._load_image(i, size, rng)
                images.append(img)
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
            if self.with_crop_info:
                # [h_orig, w_orig, crop_y, crop_x, h, w]; a latent loaded
                # from a disk cache has no geometry: uncropped at the target
                crop_infos.append([crop_info['original_size'][1], crop_info['original_size'][0],
                                   crop_info['crop_coord'][1], crop_info['crop_coord'][0], h, w]
                                  if crop_info is not None else [h, w, 0, 0, h, w])

        batch: Dict[str, Any] = {'loss_weight': np.float32(self.loss_weight)}
        if latents and not images:
            batch['latents'] = np.stack(latents)
        elif images:
            batch['images'] = np.stack(images)
        if self.frontend is not None:
            if self.dream_artist:
                # the step splits the ids into [neg..., pos...] halves
                pairs = [p if isinstance(p, (list, tuple)) else (p, p) for p in prompts]
                texts = [p[0] for p in pairs] + [p[1] for p in pairs]
            else:
                texts = [p if isinstance(p, str) else p[-1] for p in prompts]
            batch['input_ids'], batch['token_mult'] = self.frontend.tokenize_batch(texts)
        else:
            batch['prompts'] = prompts
        if att_masks:
            batch['att_mask'] = np.stack(att_masks).astype(np.float32)
        if crop_infos:
            batch['time_ids'] = np.asarray(crop_infos, np.float32)
        return batch


class CropInfoPairDataset(TextImagePairDataset):
    """SDXL's dataset: ``with_crop_info`` on by default."""

    def __init__(self, *a, **kw):
        kw.setdefault('with_crop_info', True)
        super().__init__(*a, **kw)


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
