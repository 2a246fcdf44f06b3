"""Host-side input pipeline: glob -> decode -> shuffle -> batch -> prefetch
(pathtracker_tpu/data/pipeline.py).

The reference's tf.data pipeline (reference utils/TFRDataset.py:31-53):
TFRecordDataset(GZIP) -> map(decode) -> shuffle(1000, reshuffled each
iteration) -> batch(drop_remainder). Batches are uint8 numpy arrays
([B,T,H,W,3] clips, [B] labels); normalisation and layout happen on the
device in data/prepare.py. A producer thread keeps a few batches ahead of
the consumer.

Two batch orders, picked by whether the native reader is available:
  * native: shuffled shard order, one permutation per shard, batches
    gathered with one fancy-index copy, remainders carried across shards;
  * Python: the records streamed through a shuffle buffer.
Every random draw comes from ``self._rng``, a numpy generator, in the JAX
package's order, so the same files and seed give the same batches there
and here.
"""

from __future__ import annotations

import glob as _glob
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pathtracker_torch.data import native as _native
from pathtracker_torch.data.tfrecord import read_clip_records


class ClipDataset:
    """Re-iterable dataset of (clip_batch, label_batch) numpy arrays."""

    def __init__(
        self,
        files: list[str],
        batch_size: int,
        timesteps: int,
        height: int = 32,
        width: int = 32,
        drop_remainder: bool = True,
        shuffle_buffer: int = 1000,
        seed: int | None = None,
        prefetch: int = 4,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        if not files:
            raise ValueError("no input files")
        if not (0 <= shard_index < shard_count):
            raise ValueError(f"shard_index {shard_index} not in "
                             f"[0, {shard_count})")
        self.files = list(files)
        # Multi-process sharding: each process reads a disjoint slice whose
        # union is the whole dataset. Files round-robin where there are at
        # least as many files as processes, else records are strided.
        self._record_stride = None
        if shard_count > 1:
            if len(self.files) >= shard_count:
                self.files = self.files[shard_index::shard_count]
            else:
                self._record_stride = (shard_index, shard_count)
        self.batch_size = batch_size
        self.timesteps = timesteps
        self.height = height
        self.width = width
        self.drop_remainder = drop_remainder
        self.shuffle_buffer = shuffle_buffer
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    # -- record streaming ---------------------------------------------------

    def _iter_records(self):
        files = list(self.files)
        if self.shuffle_buffer > 0 and self._record_stride is None:
            # Striding keeps the canonical file order: a global record index
            # must mean the same on every process and in every epoch.
            self._rng.shuffle(files)
        # Striding runs over the GLOBAL record index, continuous across
        # files, and the final incomplete stride block is dropped, so every
        # process yields exactly floor(N/cnt) records: one extra batch on
        # one process would leave it in a collective its peers never enter.
        gi = 0
        pending = None  # last matched record, held until its block completes
        pending_block = -1
        lo = cnt = None
        if self._record_stride is not None:
            lo, cnt = self._record_stride
        for path in files:
            if _native.available():
                records = _native.read_clip_records(
                    path, self.timesteps, self.height, self.width)
            else:
                records = read_clip_records(
                    path, self.timesteps, self.height, self.width)
            if self._record_stride is None:
                yield from records
                continue
            for item in records:
                if gi % cnt == lo:
                    if pending is not None:
                        yield pending
                    pending = item
                    pending_block = gi // cnt
                gi += 1
        if pending is not None and (pending_block + 1) * cnt <= gi:
            yield pending  # its stride block is complete

    def _iter_shuffled(self):
        if self.shuffle_buffer <= 0:
            yield from self._iter_records()
            return
        buf = []
        rng = self._rng
        for item in self._iter_records():
            if len(buf) < self.shuffle_buffer:
                buf.append(item)
                continue
            j = rng.integers(0, len(buf))
            buf[j], item = item, buf[j]
            yield item
        rng.shuffle(buf)
        yield from buf

    def _iter_batches_native(self):
        """Decode a whole shard with the C++ reader, permute its clip
        indices and gather each batch with one fancy-index copy (per-clip
        copies of 50-200 KB dominated the pipeline). The shuffle is the
        shuffled shard order plus a full permutation within each shard;
        batch remainders carry across shard boundaries."""
        files = list(self.files)
        if self.shuffle_buffer > 0 and self._record_stride is None:
            self._rng.shuffle(files)  # canonical order under striding
        rem_clips: list[np.ndarray] = []
        rem_labels: list[np.ndarray] = []
        bs = self.batch_size

        def open_shard(path):
            return _native.ShardView(path, self.timesteps, self.height,
                                     self.width)

        # Shard i+1 is decoded on a worker thread (the ctypes call releases
        # the GIL) while batches are gathered from shard i.
        pool = ThreadPoolExecutor(max_workers=1)
        futures = [pool.submit(open_shard, files[0])]
        # Global-index striding, final incomplete block dropped: as in
        # _iter_records.
        stride_base = 0
        try:
            for fi in range(len(files)):
                if fi + 1 < len(files):
                    futures.append(pool.submit(open_shard, files[fi + 1]))
                with futures.pop(0).result() as shard:
                    n = len(shard)
                    order = (self._rng.permutation(n) if self.shuffle_buffer > 0
                             else np.arange(n))
                    if self._record_stride is not None:
                        lo, cnt = self._record_stride
                        order = order[(order + stride_base) % cnt == lo]
                        if fi == len(files) - 1:
                            # N is known only at the last shard.
                            total = stride_base + n
                            order = order[order + stride_base
                                          < (total // cnt) * cnt]
                        stride_base += n
                        n = len(order)
                    start = 0
                    if rem_clips:
                        have = sum(c.shape[0] for c in rem_clips)
                        take = min(bs - have, n)
                        rem_clips.append(shard.clips[order[:take]])
                        rem_labels.append(shard.labels[order[:take]])
                        start = take
                        if have + take == bs:
                            yield (np.concatenate(rem_clips),
                                   np.concatenate(rem_labels))
                            rem_clips, rem_labels = [], []
                    while start + bs <= n:
                        idx = order[start:start + bs]
                        yield shard.clips[idx], shard.labels[idx].copy()
                        start += bs
                    if start < n:
                        rem_clips.append(shard.clips[order[start:]])
                        rem_labels.append(shard.labels[order[start:]])
        finally:
            for fut in futures:  # shards decoded ahead and never consumed
                try:
                    fut.result().close()
                except (OSError, RuntimeError):
                    pass
            pool.shutdown(wait=False)
        while rem_clips:
            clips = np.concatenate(rem_clips)
            labels = np.concatenate(rem_labels)
            rem_clips, rem_labels = [], []
            if clips.shape[0] >= bs:
                yield clips[:bs], labels[:bs]
                if clips.shape[0] > bs:
                    rem_clips, rem_labels = [clips[bs:]], [labels[bs:]]
            elif not self.drop_remainder:
                yield clips, labels

    def _iter_batches(self):
        if _native.available():
            yield from self._iter_batches_native()
            return
        clips, labels = [], []
        for clip, label in self._iter_shuffled():
            clips.append(clip)
            labels.append(label)
            if len(clips) == self.batch_size:
                yield np.stack(clips), np.asarray(labels, dtype=np.uint8)
                clips, labels = [], []
        if clips and not self.drop_remainder:
            yield np.stack(clips), np.asarray(labels, dtype=np.uint8)

    # -- prefetching iterator ----------------------------------------------

    def __iter__(self):
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list[BaseException] = []

        def producer():
            try:
                for batch in self._iter_batches():
                    q.put(batch)
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


def tfr_data_loader(
    data_dir: str = "",
    batch_size: int = 32,
    drop_remainder: bool = True,
    shuffle_buffer: int = 1000,
    timesteps: int = 64,
    height: int = 32,
    width: int = 32,
    seed: int | None = None,
    shard_index: int = 0,
    shard_count: int = 1,
) -> ClipDataset:
    """Build a clip loader from a glob pattern (e.g. root + 'test-*').

    The signature of the reference's tfr_data_loader (reference
    utils/TFRDataset.py:31), with the height/width/shuffle_buffer keywords
    its viz script passes (reference viz_model_att.py:156).
    ``shard_index``/``shard_count`` give each process of a multi-process run
    a disjoint slice.
    """
    files = sorted(_glob.glob(data_dir))
    return ClipDataset(
        files,
        batch_size=batch_size,
        timesteps=timesteps,
        height=height,
        width=width,
        drop_remainder=drop_remainder,
        shuffle_buffer=shuffle_buffer,
        seed=seed,
        shard_index=shard_index,
        shard_count=shard_count,
    )
