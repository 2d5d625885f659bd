"""Batched, prefetching data loader of fixed-shape numpy batches (port of
`data/loader.py`, the same code):

    image  uint8  [B, S, S, 3]   (normalization happens on the device)
    boxes  f32    [B, M, 4] xyxy pixels
    labels i32    [B, M]
    mask   bool   [B, M]
    image_id i64  [B]
    (segmentation) masks_packed uint8 [B, M, Hp, ceil(Wp/8)], and gt_rles, a
    host-only ragged list of per-image RLE lists

A background thread prefetches batches; with `num_workers > 1` a thread pool
fetches the samples of a batch, each with its own RNG seeded from the
batch RNG (deterministic under concurrency). The shuffle is
`RandomState(seed + epoch)`, `epoch` advances after a full pass,
`drop_last=True` keeps training steps one shape, and eval pads the final
partial batch with `image_id = -1` images and reports `nvalid`. A worker's
exception is re-raised in the consumer.

`rows` (data-parallel training, `parallel.DataParallel.batch_rows`) makes
the loader yield only those rows of each batch: the shuffle and the
per-sample seeds are drawn for the whole batch, and only this process's
samples are fetched and decoded (mosaic and cutmix partners come from the
sample's own RNG), so the rows equal the single-process batch's. The
per-sample seeding is the `num_workers > 1` scheme, used here whatever
`num_workers` is: with 0 or 1 workers a single process chains one RNG
through the batch, which a process could only replay by decoding every
other row. A padded final batch pads the rows past the last image (an
all-padding share copies the shapes of the batch's first sample), and
`nvalid` stays the whole batch's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from yololite_tpu_torch.data.dataset import YoloDataset


def collate(samples) -> Dict[str, np.ndarray]:
    keys = ["image", "boxes", "labels", "mask"]
    keys += [k for k in ("masks", "masks_packed") if k in samples[0]]
    out = {k: np.stack([s[k] for s in samples]) for k in keys}
    if "gt_rles" in samples[0]:
        out["gt_rles"] = [s["gt_rles"] for s in samples]
    out["image_id"] = np.asarray([s["image_id"] for s in samples], np.int64)
    return out


def _pad_like(sample):
    """A padding sample: zeros of `sample`'s shapes, image_id -1."""
    pad = {k: ([] if isinstance(v, list) else np.zeros_like(v))
           for k, v in sample.items()}
    pad["image_id"] = np.int64(-1)
    return pad


class _WorkerError:
    """Exception captured in the prefetch worker, re-raised in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataLoader:
    """Iterates shuffled (or sequential) fixed-shape batches with prefetch.

    `num_workers` threads fetch samples concurrently inside the prefetch
    worker (the host codecs, zlib and large numpy ops release the GIL)."""

    def __init__(self, dataset: YoloDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 3,
                 num_workers: int = 0, rows: Optional[slice] = None):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = int(num_workers)
        self.rows = rows
        self.epoch = 0

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        nb = len(self)
        for b in range(nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield chunk

    def _epoch_rng(self) -> np.random.RandomState:
        return np.random.RandomState((self.seed + self.epoch) * 7919 + 13)

    def _batch(self, chunk, rng: np.random.RandomState, pool=None) -> Dict[str, np.ndarray]:
        """The collated batch of `chunk`'s samples, drawn from `rng` as the
        iteration draws them (`pool` only fetches the samples concurrently)."""
        def fetch(pairs):
            if pool is None:
                return [self.ds.get(int(i), r) for i, r in pairs]
            return list(pool.map(lambda a: self.ds.get(int(a[0]), a[1]), pairs))

        if self.num_workers <= 1 and self.rows is None:
            samples = [self.ds.get(int(i), rng) for i in chunk]
        else:
            # one independent RNG per sample: deterministic under concurrency
            base = int(rng.randint(0, 2**31 - 1))
            rngs = [np.random.RandomState((base + 31 * k) % (2**31 - 1))
                    for k in range(len(chunk))]
            if self.rows is None:
                samples = fetch(zip(chunk, rngs))
            else:
                mine = range(*self.rows.indices(self.batch_size))
                samples = fetch([(chunk[k], rngs[k]) for k in mine if k < len(chunk)])
                if not samples:     # padding only: the shapes of the first sample
                    samples = [_pad_like(self.ds.get(int(chunk[0]), rngs[0]))]
        want = (self.batch_size if self.rows is None else
                len(range(*self.rows.indices(self.batch_size))))
        while len(samples) < want:  # pad final batch (eval)
            samples.append(_pad_like(samples[0]))
        batch = collate(samples)
        batch["nvalid"] = np.int32(len(chunk))
        return batch

    def first_batch(self) -> Dict[str, np.ndarray]:
        """The batch that iterating would yield first, made in this thread
        (exactly one batch of samples is read, none prefetched); the epoch
        does not advance. StopIteration when there is no batch."""
        return self._batch(next(self._index_batches()), self._epoch_rng())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        pool = None
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def worker():
            rng = self._epoch_rng()
            try:
                for chunk in self._index_batches():
                    if stop.is_set():
                        return
                    q.put(self._batch(chunk, rng, pool))
            except BaseException as e:  # propagate to the consumer, don't
                q.put(_WorkerError(e))  # silently truncate the epoch
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, _WorkerError):
                    raise RuntimeError("DataLoader worker failed") from batch.exc
                yield batch
        finally:
            stop.set()
            if pool is not None:
                pool.shutdown(wait=False)
        self.epoch += 1
