"""Degradation data pipeline: clean images -> (x0, xt, t, quality) batches
(port of data/pipeline.py; numpy and Pillow, and the C++ codec engine of
codecs/native.py for the native_surrogate backend).

Degradation runs in the host input pipeline: background producer threads
assemble batches (the host codec inside), prefetched in a queue, so codec
work overlaps the device's train step.

Batch content is a pure function of (seed, epoch, batch index) — each batch
draws from its own derived RNG stream — so the stream is identical whether
batches are produced serially or by ``num_workers`` threads, a resumed run
sees exactly the data a run without the interruption would have, and the
batches equal the JAX package's. A data-parallel rank (`rows`) draws the
random fields of the whole batch from that stream and decodes and degrades
only its own block of rows, so the ranks' blocks make up the one-process
batch.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import compress_batch
from ddpm_image_restoration_tpu_torch.codecs.quality import (
    quality_for_timestep,
    sample_quality_range,
)
from ddpm_image_restoration_tpu_torch.config import CODECS, CodecPreset


def prefetched_map(fn, n: int, num_workers: int, prefetch: int = 2):
    """Yield fn(0), fn(1), ..., fn(n-1) strictly in order.

    num_workers > 1 computes ahead on a thread pool with a bounded sliding
    window (num_workers + prefetch in flight — the host-memory bound), so
    `fn` must be order-independent (give it its own RNG stream per index).
    Early generator exit cancels pending work without blocking on it, and
    retrieves completed futures' exceptions so none surface as
    'exception was never retrieved' noise."""
    if num_workers <= 1:
        for b in range(n):
            yield fn(b)
        return
    pool = ThreadPoolExecutor(max_workers=num_workers)
    futures: "collections.deque" = collections.deque()
    nxt = 0
    try:
        for _ in range(min(num_workers + prefetch, n)):
            futures.append(pool.submit(fn, nxt))
            nxt += 1
        while futures:
            out = futures.popleft().result()
            if nxt < n:
                futures.append(pool.submit(fn, nxt))
                nxt += 1
            yield out
    finally:
        for f in futures:
            f.cancel()
            if f.done() and not f.cancelled():
                f.exception()
        pool.shutdown(wait=False, cancel_futures=True)


class DegradationLoader:
    """Iterable over degraded training batches for one epoch at a time.

    Yields dicts with:
      x0      [B,H,W,3] float32 clean images in [-1,1]
      xt      [B,H,W,3] float32 codec-degraded images
      t       [B] int32 timesteps in [1, steps)
      quality [B] int32 per-sample codec quality
    """

    def __init__(
        self,
        dataset,
        indices: Sequence[int],
        preset: CodecPreset,
        batch_size: int,
        steps: int = 100,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
        drop_remainder: bool = True,
        degradation_backend: str = "pil",
        num_workers: int = 0,
        augment: bool = False,
        rows: Tuple[int, int] = (0, 1),
    ):
        """degradation_backend: 'pil' — real codec bitstreams via
        libjpeg/libwebp/libaom (reference-exact degradation);
        'native_surrogate' — the C++ codec engine (codecs/native.py): the
        on-device surrogate's degradation model on the host, batched and
        threaded, so training pairs match the sampler's consistency step.

        num_workers: batch-producer threads. 0/1 = one background producer;
        N > 1 = a thread pool decoding and degrading N batches concurrently
        (PIL decode and the codec round-trips release the GIL). Batch
        content is identical for any worker count.

        rows: (r, n) yields the r-th of n equal blocks of rows of each batch
        of `batch_size` (a data-parallel rank's share; `batch_size` a
        multiple of n).
        """
        if batch_size % rows[1]:
            raise ValueError(f"batch size {batch_size} is not a multiple of the "
                             f"{rows[1]} data-parallel ranks")
        self.dataset = dataset
        self.indices = np.asarray(indices)[host_id::num_hosts]
        self.preset = preset
        self.batch_size = batch_size
        self.steps = steps
        self.seed = seed
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        if degradation_backend not in ("pil", "native_surrogate"):
            raise ValueError(degradation_backend)
        self.degradation_backend = degradation_backend
        self.num_workers = num_workers
        self.augment = augment
        self.rows = rows

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return len(self.indices) // self.batch_size
        return -(-len(self.indices) // self.batch_size)

    def _make_batch(self, idxs, epoch: int, batch_idx: int) -> Dict:
        # Own RNG stream per (seed, epoch, batch): deterministic and
        # order-independent, so parallel workers produce the serial stream.
        rng = np.random.default_rng((self.seed, epoch, batch_idx))
        n_all = len(idxs)
        r, n = self.rows
        mine = slice(r * n_all // n, (r + 1) * n_all // n)
        x0 = np.stack([self.dataset[int(i)] for i in idxs[mine]])
        if self.augment:
            # dihedral-8 augmentation of the CLEAN image before degradation,
            # so xt stays the true codec round-trip of the training target
            # (same rng stream: deterministic + worker-count independent)
            ks = rng.integers(0, 4, size=n_all)[mine]
            fl = rng.integers(0, 2, size=n_all)[mine]
            x0 = np.stack([
                np.ascontiguousarray(
                    np.rot90(img[:, ::-1] if f else img, int(k), axes=(0, 1))
                )
                for img, k, f in zip(x0, ks, fl)
            ])
        qr = sample_quality_range(rng, epoch, self.preset)
        t = rng.integers(1, self.steps, size=n_all)[mine]
        quality = quality_for_timestep(t, self.steps, qr)
        quality = np.maximum(quality, self.preset.quality_min)
        batch = {
            "x0": x0.astype(np.float32),
            "t": t.astype(np.int32),
            "quality": quality.astype(np.int32),
        }
        if self.preset.name == "all":
            # unified multi-codec training: per-sample codec choice (drawn
            # AFTER the shared fields, so jpeg/webp/avif batch streams are
            # untouched); the batch carries the conditioning ids
            codec_ids = rng.integers(0, len(CODECS), size=n_all)[mine]
            xt = np.empty_like(x0)
            for ci, cname in enumerate(CODECS):
                m = codec_ids == ci
                if m.any():
                    xt[m] = self._degrade(x0[m], quality[m], cname)
            batch["codec_id"] = codec_ids.astype(np.int32)
        else:
            xt = self._degrade(x0, quality, self.preset.name)
        batch["xt"] = xt.astype(np.float32)
        return batch

    def _degrade(self, x0, quality, codec: str):
        if self.degradation_backend == "native_surrogate":
            from ddpm_image_restoration_tpu_torch.codecs.native import codec_surrogate_native

            return codec_surrogate_native(x0, np.maximum(quality, 1), codec)
        return compress_batch(x0, codec, quality)

    def _batch_indices(self, epoch: int):
        order = np.random.default_rng((self.seed, epoch)).permutation(len(self.indices))
        return [
            self.indices[order[b * self.batch_size : (b + 1) * self.batch_size]]
            for b in range(self.steps_per_epoch())
        ]

    def epoch(self, epoch: int) -> Iterator[Dict]:
        """Background-producer iterator over one epoch's batches (in order)."""
        batches = self._batch_indices(epoch)
        if self.num_workers > 1:
            yield from self._epoch_pooled(batches, epoch)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()

        def produce():
            try:
                for b, idxs in enumerate(batches):
                    q.put(self._make_batch(idxs, epoch, b))
            except BaseException as e:  # surface producer errors to the consumer
                q.put(e)
            finally:
                q.put(_SENTINEL)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def _epoch_pooled(self, batches, epoch: int) -> Iterator[Dict]:
        """num_workers>1: sliding window of in-flight batch futures; results
        are consumed strictly in batch order, which the per-batch RNG
        streams make identical to serial."""
        yield from prefetched_map(
            lambda b: self._make_batch(batches[b], epoch, b),
            len(batches), self.num_workers, self.prefetch,
        )

    def eval_batches(self, batch_size: Optional[int] = None) -> Iterator[np.ndarray]:
        """Deterministic clean-image batches (for validation/eval harness),
        decoded ahead on the worker pool when num_workers > 1."""
        bs = batch_size or self.batch_size
        n_batches = -(-len(self.indices) // bs)

        def make(b: int) -> np.ndarray:
            idxs = self.indices[b * bs : (b + 1) * bs]
            return np.stack([self.dataset[int(i)] for i in idxs])

        yield from prefetched_map(make, n_batches, self.num_workers, self.prefetch)
