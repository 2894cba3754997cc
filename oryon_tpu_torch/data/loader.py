"""Background-prefetching batch loader.

The port's own copy of ``oryon_tpu/data/loader.py``: one background thread
reads, augments and collates PairBatches ahead of the device (PIL and numpy
release the GIL, so the host work overlaps the device's), a small queue
keeps ``prefetch`` batches ready, and a strided per-process split supports
several input processes.  Order and padding are the JAX package's: pairs
grouped by class when asked, a short last batch padded with its last pair
and those pads marked invalid.  Unlike the JAX loader, an error in the
worker is raised again on the caller's thread instead of ending the
iteration early.

Invariants across processes: the per-epoch shuffle seed comes from a
process-independent counter (base_seed + epoch), not from the dataset's
RNG, and with ``drop_last`` every process yields the same number of
batches.

Data-parallel ranks (``rows``): every rank walks the single-device order of
the same seed and reads every pair of each global batch, so the dataset's
host draws (prompt synsets, correspondence sampling) follow one stream, and
collates only its rows (``parallel.mesh.batch_rows``): n ranks train on
exactly the batches of one device.  Reading the other ranks' pairs is host
work that one device would also do; it is not split.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 sort_by_class: bool = False, seed: int = None,
                 train: bool = False, rows=None):
        self.dataset = dataset
        # rows: this data rank's rows of each global batch (None: all)
        self.rows = None if rows is None else [int(i) for i in rows]
        self.batch_size = batch_size
        # train=True collates the training subset only (no depth or pose);
        # otherwise the worker builds its tensors in inference mode
        self.train = train
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.sort_by_class = sort_by_class
        if seed is None:
            # drawn once, and only to shuffle: an eval loader must not move
            # the dataset's RNG stream
            seed = (int(getattr(dataset, "rs", np.random).randint(2 ** 31))
                    if shuffle else 0)
        self.base_seed = seed
        self._epoch = 0

    def _shard_len(self, rank: int) -> int:
        n = len(self.dataset)
        return (n - rank + self.process_count - 1) // self.process_count

    def __len__(self) -> int:
        if self.drop_last:
            return min(self._shard_len(r) for r in
                       range(self.process_count)) // self.batch_size
        return -(-self._shard_len(self.process_index) // self.batch_size)

    def _index_batches(self, rs: np.random.RandomState):
        order = np.arange(len(self.dataset))
        if self.sort_by_class:
            # same-class pairs together: fewer class groups a batch to score
            keys = [str(inst[4]) for inst in self.dataset.instances]
            order = order[np.argsort(np.asarray(keys)[order], kind="stable")]
        if self.shuffle:
            rs.shuffle(order)
        order = order[self.process_index::self.process_count]
        limit = len(self) if self.drop_last else None
        emitted = 0
        for s in range(0, len(order), self.batch_size):
            if limit is not None and emitted >= limit:
                return
            idx = order[s: s + self.batch_size]
            n_real = len(idx)
            if n_real < self.batch_size:
                if self.drop_last:
                    return
                idx = np.concatenate([idx, np.full(self.batch_size - n_real, idx[-1])])
            emitted += 1
            yield idx, n_real

    def __iter__(self) -> Iterator:
        rs = np.random.RandomState(
            (self.base_seed + self._epoch) % (2 ** 31) if self.shuffle else 0)
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batches = list(self._index_batches(rs))
        stop = threading.Event()
        failure = []

        def worker():
            try:
                with torch.inference_mode(not self.train):
                    for idx, n_real in batches:
                        if stop.is_set():
                            return
                        pairs = [self.dataset.get_pair(int(i), train=self.train)
                                 for i in idx]
                        for p in pairs[n_real:]:
                            p["valid"] = 0.0   # final-batch pads
                        if self.rows is not None:
                            pairs = [pairs[i] for i in self.rows]
                        out_q.put(self.dataset.collate(pairs, train=self.train))
            except BaseException as e:     # raised again on the caller's thread
                failure.append(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=worker, daemon=True, name="oryon-loader")
        t.start()
        try:
            while True:
                b = out_q.get()
                if b is None:
                    break
                yield b
            if failure:
                raise failure[0]
        finally:
            # a worker parked in out_q.put() on the full queue never sees
            # stop: keep draining until the thread has exited
            stop.set()
            while t.is_alive():
                try:
                    while True:
                        out_q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
