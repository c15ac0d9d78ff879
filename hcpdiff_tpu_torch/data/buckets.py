"""Aspect-Ratio Bucketing (ARB): a copy of ``hcpdiff_tpu/data/buckets.py``.

Images are grouped into a small set of (w, h) buckets (k-means over
log-aspect-ratios); every batch is drawn from one bucket. The k-means
seed (42), the epoch shuffle (seed 42 + epoch) and the padding of each
bucket to a multiple of ``bs x world_size`` are the JAX package's, so
both packages put the same files in the same buckets in the same order.

Added here: ``check_sizes``. Both packages' UNets upsample by a plain x2,
so a bucket whose latent sides do not divide by 2 ** (down-sampling
levels) fails at an up-block concatenation (SD1.5 with the default
``step_size: 8``: a 3:2 image gets 624x416, latents 78x52, and
39 -> 20 -> 40). The trainer checks every bucket that holds files when
the dataset is built, and raises naming the bucket and the step size
that avoids it.
"""
from __future__ import annotations

import math
import os
import pickle
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


def closest_size(w: int, h: int, target_area: int, step: int = 8) -> Tuple[int, int]:
    """Scale (w,h) to ~target_area keeping ratio, snapped to step multiples."""
    ratio = w / h
    new_h = math.sqrt(target_area / ratio)
    new_w = new_h * ratio
    return (max(step, round(new_w / step) * step),
            max(step, round(new_h / step) * step))


def _kmeans_1d(x: np.ndarray, k: int, seed: int = 42, iters: int = 50) -> np.ndarray:
    """1-D k-means (log-ratio clustering). Returns centers sorted ascending."""
    rng = np.random.default_rng(seed)
    uniq = np.unique(x)
    k = min(k, len(uniq))
    centers = np.sort(rng.choice(uniq, size=k, replace=False))
    for _ in range(iters):
        assign = np.argmin(np.abs(x[:, None] - centers[None, :]), axis=1)
        new = np.array([x[assign == i].mean() if (assign == i).any() else centers[i]
                        for i in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    return np.sort(centers)


class BaseBucket:
    """Interface: build(file_infos, bs) -> None; then len() batches of
    (indices, (w, h)); rest(epoch) reshuffles deterministically."""

    can_shuffle = True

    def build(self, file_infos: Sequence[Tuple[Any, Tuple[int, int]]], bs: int,
              world_size: int = 1) -> None:
        raise NotImplementedError

    def rest(self, epoch: int) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        raise NotImplementedError

    def crop_resize(self, img, size, rng=None):
        from .utils import resize_crop_fix
        return resize_crop_fix(img, size, rng)

    def used_sizes(self) -> List[Tuple[int, int]]:
        """The (w, h) of every bucket that holds at least one file."""
        raise NotImplementedError

    def check_sizes(self, multiple: int) -> None:
        """Raise unless every used bucket's sides divide by ``multiple``
        pixels (the VAE's scale times the UNet's 2 ** down-sampling levels)."""
        bad = [s for s in self.used_sizes() if s[0] % multiple or s[1] % multiple]
        if bad:
            raise ValueError(
                f'{type(self).__name__}: bucket(s) {bad} (w, h) have sides that are not '
                f'multiples of {multiple} px, so their latents cannot pass the UNet\'s '
                f'down- and up-sampling (its x2 upsample meets an odd side); set the '
                f'bucket\'s step_size: {multiple} (or a target size that is a multiple '
                f'of {multiple})')


class FixedBucket(BaseBucket):
    """All images resize-cropped to one target size
    (reference bucket.py:47-85)."""

    def __init__(self, target_size: int | Tuple[int, int] = 512, **kw):
        if isinstance(target_size, int):
            target_size = (target_size, target_size)
        self.target_size = tuple(target_size)

    def build(self, file_infos, bs, world_size: int = 1):
        self.bs = bs
        n = len(file_infos)
        mult = bs * world_size
        pad_to = ((n + mult - 1) // mult) * mult
        idx = np.arange(n)
        extra = np.resize(idx, pad_to - n) if pad_to > n else np.array([], np.int64)
        self.indices = np.concatenate([idx, extra]).astype(np.int64)
        self.rest(0)

    def rest(self, epoch: int):
        rng = np.random.default_rng(42 + epoch)
        self.order = rng.permutation(self.indices)

    def used_sizes(self):
        return [self.target_size] if len(self.indices) else []

    def __len__(self):
        return len(self.order) // self.bs

    def __getitem__(self, i):
        return self.order[i * self.bs:(i + 1) * self.bs], self.target_size


class RatioBucket(BaseBucket):
    """k-means aspect-ratio buckets (reference bucket.py:87-229)."""

    def __init__(self, target_area: int = 512 * 512, step_size: int = 8,
                 num_bucket: int = 10, ratio_max: float = 4.0,
                 pre_build_bucket: Optional[str] = None, **kw):
        self.target_area = int(target_area)
        self.step = int(step_size)
        self.num_bucket = int(num_bucket)
        self.ratio_max = float(ratio_max)
        self.cache_path = pre_build_bucket
        self._mode = 'files'

    @classmethod
    def from_files(cls, target_area: int = 512 * 512, step_size: int = 8,
                   num_bucket: int = 10, **kw) -> 'RatioBucket':
        b = cls(target_area, step_size, num_bucket, **kw)
        b._mode = 'files'
        return b

    @classmethod
    def from_ratios(cls, target_area: int = 512 * 512, step_size: int = 8,
                    num_bucket: int = 10, ratio_max: float = 4.0, **kw) -> 'RatioBucket':
        b = cls(target_area, step_size, num_bucket, ratio_max, **kw)
        b._mode = 'ratios'
        return b

    def _make_sizes(self, log_ratios: np.ndarray) -> List[Tuple[int, int]]:
        if self._mode == 'ratios':
            # enumerate snapped (w,h) near target area within ratio_max
            cands = []
            w = self.step
            while True:
                h = self.target_area / w
                h = max(self.step, round(h / self.step) * self.step)
                r = w / h
                if r > self.ratio_max:
                    break
                if r >= 1.0 / self.ratio_max:
                    cands.append(math.log(r))
                w += self.step
            arr = np.array(sorted(set(cands)))
        else:
            arr = log_ratios
        centers = _kmeans_1d(arr, self.num_bucket, seed=42)
        sizes = []
        for c in centers:
            r = math.exp(c)
            h = math.sqrt(self.target_area / r)
            w = h * r
            sizes.append((max(self.step, round(w / self.step) * self.step),
                          max(self.step, round(h / self.step) * self.step)))
        # dedup keeping order
        seen, out = set(), []
        for s in sizes:
            if s not in seen:
                seen.add(s)
                out.append(s)
        return out

    def build(self, file_infos, bs, world_size: int = 1):
        self.bs = bs
        if self.cache_path and os.path.exists(self.cache_path):
            with open(self.cache_path, 'rb') as f:
                data = pickle.load(f)
            self.sizes, self.buckets = data['sizes'], data['buckets']
            self.rest(0)
            return
        ratios = np.array([w / h for _, (w, h) in file_infos], np.float64)
        ratios = np.clip(ratios, 1.0 / self.ratio_max, self.ratio_max)
        log_r = np.log(ratios)
        self.sizes = self._make_sizes(log_r)
        size_log_r = np.log([w / h for w, h in self.sizes])
        assign = np.argmin(np.abs(log_r[:, None] - size_log_r[None, :]), axis=1)

        mult = bs * world_size
        self.buckets = []
        for bi in range(len(self.sizes)):
            idx = np.nonzero(assign == bi)[0]
            if len(idx) == 0:
                self.buckets.append(idx.astype(np.int64))
                continue
            pad_to = ((len(idx) + mult - 1) // mult) * mult
            extra = np.resize(idx, pad_to - len(idx)) if pad_to > len(idx) \
                else np.array([], np.int64)
            self.buckets.append(np.concatenate([idx, extra]).astype(np.int64))
        if self.cache_path:
            with open(self.cache_path, 'wb') as f:
                pickle.dump({'sizes': self.sizes, 'buckets': self.buckets}, f)
        self.rest(0)

    def used_sizes(self):
        return [s for s, idx in zip(self.sizes, self.buckets) if len(idx)]

    def rest(self, epoch: int):
        """Deterministic epoch shuffle: permute within buckets, then permute
        the global batch order (reference bucket.py:193-204)."""
        rng = np.random.default_rng(42 + epoch)
        batches: List[Tuple[np.ndarray, Tuple[int, int]]] = []
        for bi, idx in enumerate(self.buckets):
            if len(idx) == 0:
                continue
            perm = rng.permutation(idx)
            for j in range(len(perm) // self.bs):
                batches.append((perm[j * self.bs:(j + 1) * self.bs],
                                self.sizes[bi]))
        order = rng.permutation(len(batches))
        self.batches = [batches[i] for i in order]

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]


class SizeBucket(RatioBucket):
    """Cluster over actual (w,h) sizes instead of area-normalized ratios
    (reference bucket.py:231-270): bucket sizes come from the files' own
    snapped dimensions."""

    def _make_sizes(self, log_ratios):
        return self._file_sizes

    def build(self, file_infos, bs, world_size: int = 1):
        sizes = {}
        for _, (w, h) in file_infos:
            s = (max(self.step, round(w / self.step) * self.step),
                 max(self.step, round(h / self.step) * self.step))
            sizes[s] = sizes.get(s, 0) + 1
        top = sorted(sizes.items(), key=lambda kv: -kv[1])[:self.num_bucket]
        self._file_sizes = [s for s, _ in top]
        super().build(file_infos, bs, world_size)


class LongEdgeBucket(RatioBucket):
    """Scale so the long edge matches ``target_edge`` (reference
    bucket.py:318-357)."""

    def __init__(self, target_edge: int = 512, step_size: int = 8,
                 num_bucket: int = 10, **kw):
        super().__init__(target_edge * target_edge, step_size, num_bucket, **kw)
        self.target_edge = int(target_edge)

    def _make_sizes(self, log_ratios):
        centers = _kmeans_1d(log_ratios, self.num_bucket, seed=42)
        sizes = []
        for c in centers:
            r = math.exp(c)
            if r >= 1:
                w, h = self.target_edge, self.target_edge / r
            else:
                w, h = self.target_edge * r, self.target_edge
            sizes.append((max(self.step, round(w / self.step) * self.step),
                          max(self.step, round(h / self.step) * self.step)))
        seen, out = set(), []
        for s in sizes:
            if s not in seen:
                seen.add(s)
                out.append(s)
        return out


BUCKETS = {
    'fixed': FixedBucket,
    'ratio': RatioBucket,
    'size': SizeBucket,
    'long_edge': LongEdgeBucket,
}
