"""Host batching and the copy to the device (counterpart of
``ssde_tpu/data/pipeline.py``).

A thread pool (or, with ``use_processes``, a process pool) decodes items and
collates them ahead of the training step (numpy, NHWC, as the JAX package's
loader gives them); the main thread then copies each batch to the device
from page-locked memory, without blocking, on the current stream. The batch
order is the JAX loader's: the same ``random.Random(seed)`` shuffle.
"""

from __future__ import annotations

import queue
import random
import threading
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from ..parallel.mesh import shard_rows


def collate(items):
    """Stack a list of item dicts into one batch dict of numpy arrays;
    uint8 frames stay uint8 (a quarter of the copy), the rest is float32."""
    out = {}
    for k in items[0]:
        arr = np.stack([it[k] for it in items])
        out[k] = arr if arr.dtype == np.uint8 else arr.astype(np.float32)
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; for a CUDA device from pinned
    host memory with ``non_blocking`` copies on the current stream. Tensors
    already on ``device`` are kept."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):  # already sent (parallel.device_prefetch)
            out[k] = v.to(device)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if pin
                  else t.to(device))
    return out


class Loader:
    """Batches of ``dataset`` as dicts of numpy arrays, ``prefetch``
    batches ahead of the consumer, made by ``num_workers`` threads or, with
    ``use_processes``, worker processes (``ssde_tpu/data/pipeline.py:47-63``).

    The JAX package offers processes because PIL holds the interpreter lock
    for part of each JPEG decode; they pay for pickling each decoded item
    back. On an 8-core host the threads scaled to 8 workers and the
    processes were slower at every count (``PERF.md`` §6): measure with
    ``scripts/bench_loader`` before switching. The processes are forked,
    once an epoch, with the dataset in a module global
    (only the index goes to a worker), so ``dataset.__getitem__`` must stay
    numpy and PIL: a forked child cannot use the parent's CUDA context, and
    torch raises there if it tries. The trainers keep threads, as the JAX
    trainers do. An exception in a worker, thread or process, is raised again
    in the consumer.

    ``shard=(rank, world)`` is one rank of a data-parallel mesh: every rank
    draws the same order and the same global batches of ``batch_size``
    (``len`` is theirs) and decodes only its contiguous rows of each
    (``parallel.shard_rows``), so the ranks' batches put together are the
    one-process batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, prefetch: int = 2,
                 seed: int = 0, use_processes: bool = False, shard=(0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.shard = tuple(shard)
        if batch_size % self.shard[1]:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{self.shard[1]} ranks")
        self._rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        stop = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        for i in range(0, stop, bs):
            batch = idx[i:i + bs]
            yield batch[shard_rows(len(batch), *self.shard)]

    def _make_pool(self):
        if self.use_processes:
            return ProcessPoolExecutor(self.num_workers, mp_context=mp.get_context("fork"),
                                       initializer=_init_worker, initargs=(self.dataset,))
        return ThreadPoolExecutor(self.num_workers)

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        batches = list(self._index_batches())  # shuffle on the caller's thread
        fetch = _worker_getitem if self.use_processes else self.dataset.__getitem__

        def produce():
            try:
                with self._make_pool() as pool:
                    for batch_idx in batches:
                        q.put(collate(list(pool.map(fetch, batch_idx))))
            except Exception as e:  # raised again in the consumer's thread
                q.put(e)
            q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
        t.join()


# the process pool's worker state: forked children inherit the dataset, and
# the initializer keeps it in a module global, so that a task carries only
# its integer index (ssde_tpu/data/pipeline.py:115-124)
_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_getitem(index):
    return _WORKER_DATASET[index]
