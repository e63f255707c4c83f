"""Host-side data loading (the port's copy of ``heal_swin_tpu/data/loading.py``):
map-style datasets -> batched numpy iterators with background prefetch and a
multi-worker decode pool.

The per-sample work of a real dataset is PNG/npz decode, which releases the GIL in
PIL/zlib/numpy, so a THREAD pool reaches the decode parallelism of the reference's
torch DataLoader worker processes without their spawn and IPC.  ``num_workers``
(the data configs' ``train_worker``/``val_worker``) sizes the pool; batches are
collated and handed over in a deterministic order whatever the pool's scheduling.
The batches are numpy; the trainer moves them to the device (``Trainer._device_prefetch``).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def default_collate(samples):
    """Stack dict-of-arrays / tuple-of-arrays samples into batched numpy arrays."""
    first = samples[0]
    if isinstance(first, dict):
        out = {}
        for k in first:
            vals = [s[k] for s in samples]
            if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
                out[k] = np.stack([np.asarray(v) for v in vals])
            else:
                out[k] = vals  # lists of strings / objects stay lists
        return out
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def pred_overfit_indices(train_dataset, train_indices, pred_dataset):
    """Predict-dataset indices matching the manual-overfit train subset by name
    (reference hp_datasets.py:297-307 ``get_pred_overfit_sampler``): with
    ``manual_overfit_batches`` the predict loader must rank/score exactly the
    overfit samples, not the whole train split."""
    train_names = list(train_dataset.names)
    pred_names = list(pred_dataset.names)
    idcs = [pred_names.index(train_names[int(i)]) for i in train_indices]
    assert len(idcs) == len(train_indices)
    return np.asarray(idcs, dtype=np.int64)


class DataLoader:
    """Deterministic, seedable batching over a map-style dataset.

    shuffle uses a per-epoch RandomState(seed + epoch); call set_epoch() before each
    epoch for reshuffling (like DistributedSampler.set_epoch).
    ``indices``: optional fixed subset (manual-overfit machinery).
    ``num_workers``: decode-pool threads (the reference's DataLoader num_workers);
    1 keeps the single background prefetch thread, 0/prefetch=0 is fully synchronous.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        indices: Optional[Sequence[int]] = None,
        prefetch: int = 2,
        num_workers: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.indices = np.asarray(indices) if indices is not None else None
        self.prefetch = prefetch
        self.num_workers = max(int(num_workers), 0)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        idx = self.indices if self.indices is not None else np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = idx[rng.permutation(len(idx))]
        return idx

    def __len__(self):
        n = len(self.indices) if self.indices is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        order = self._order()
        n = len(order)
        batches = []
        for start in range(0, n, self.batch_size):
            chunk = order[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            batches.append(chunk)
        return batches

    def __iter__(self) -> Iterator:
        batches = self._batches()

        if self.prefetch <= 0 or self.num_workers == 0:
            for chunk in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in chunk])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that honors stop: a plain q.put() would park the worker
            # forever when the consumer abandons the iterator mid-epoch (early
            # break, exception in the train step) with the queue full — leaking
            # the thread and prefetch+1 collated batches per abandoned epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        if self.num_workers <= 1:

            def worker():
                try:
                    for chunk in batches:
                        if stop.is_set():
                            return
                        samples = [self.dataset[int(i)] for i in chunk]
                        if not put(self.collate_fn(samples)):
                            return
                    put(None)
                except BaseException as e:  # propagate into consumer
                    put(e)

        else:
            # decode pool: per-sample dataset[i] fetches run on num_workers
            # threads; a coordinator keeps `prefetch` batches of futures in
            # flight and collates them IN ORDER, so batch content/order is
            # identical to the single-worker path for any pool size
            pool = ThreadPoolExecutor(
                max_workers=self.num_workers, thread_name_prefix="hs-decode"
            )

            def fetch(i):
                if stop.is_set():
                    return None  # drain cheaply after abandonment
                return self.dataset[int(i)]

            def worker():
                try:
                    pending: deque = deque()

                    def drain_one() -> bool:
                        futs = pending.popleft()
                        return put(self.collate_fn([f.result() for f in futs]))

                    for chunk in batches:
                        while len(pending) > max(self.prefetch, 1):
                            if stop.is_set() or not drain_one():
                                return
                        if stop.is_set():
                            return
                        pending.append([pool.submit(fetch, i) for i in chunk])
                    while pending:
                        if stop.is_set() or not drain_one():
                            return
                    put(None)
                except BaseException as e:
                    put(e)
                finally:
                    pool.shutdown(wait=False, cancel_futures=True)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
