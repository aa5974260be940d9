"""Batching, shuffling and background prefetch.

Counterpart of `sd_tpu/data/loader.py` `collate` and `DataLoader`: the same
seed-and-epoch shuffle, `drop_last`, the split of each epoch's batches over
`world` ranks (round-robin, the same list on every rank), a thread pool
that reads a batch's items ahead of the step and a bounded prefetch queue
whose producer stops when the consumer leaves early; and
`parallel_data_prefetch`, a thread-parallel map over chunks of a dataset.
`rows` keeps only those positions of every batch (a data-parallel rank's
rows, `parallel/mesh.py local_rows`): the other rows are never read.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np


def collate(items: list[dict]) -> dict:
    """Numeric fields stacked, strings and other objects collected as lists."""
    out: dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray) or (np.isscalar(vals[0])
                                               and not isinstance(vals[0], str)):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


class DataLoader:
    """Shuffled, batched, prefetching loader over a map-style dataset. Each
    `iter()` is one epoch: the epoch count advances (and reaches the
    dataset's `set_epoch`) before the order is drawn."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, prefetch: int = 2,
                 seed: int = 0, collate_fn: Callable = collate, rank: int = 0,
                 world: int = 1, rows: np.ndarray | None = None):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside world {world}")
        if rows is not None and (not drop_last or max(rows, default=-1) >= batch_size):
            raise ValueError(f"rows {list(rows)} of a batch of {batch_size} need drop_last "
                             "and positions inside the batch")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.collate_fn = collate_fn
        self.rank = rank
        self.world = world
        self.rows = None if rows is None else np.asarray(rows, dtype=np.int64)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        total = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return len(range(self.rank, total, self.world))

    def _batch_indices(self) -> list[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = []
        for s in range(0, n, self.batch_size):
            b = idx[s:s + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                break
            batches.append(b if self.rows is None else b[self.rows])
        return batches[self.rank::self.world]

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if callable(set_epoch):
            set_epoch(self._epoch)
        batches = self._batch_indices()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # re-checks `stop`: a consumer that leaves mid-epoch must not
            # strand this thread on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, b))
                        if not put(self.collate_fn(items)):
                            return
                put(None)
            except BaseException as e:    # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def parallel_data_prefetch(func: Callable, data, n_proc: int = 4,
                           target_data_type: str = "ndarray") -> Any:
    """`func` over every item of `data` (a dict's values, a list, an array),
    in `n_proc` contiguous chunks mapped by as many threads: a list of the
    results in order (`target_data_type="list"`), or their arrays stacked
    along a new first axis ("ndarray")."""
    if target_data_type not in ("ndarray", "list"):
        raise ValueError("target_data_type must be 'ndarray' or 'list'")
    if isinstance(data, np.ndarray) and target_data_type == "list":
        raise ValueError("list expected but function got ndarray")
    if isinstance(data, dict):
        data = list(data.values())
    arr = np.asarray(data, dtype=object) if target_data_type == "ndarray" else list(data)
    n = len(arr)
    n_proc = max(1, min(n_proc, n))
    step = -(-n // n_proc)
    chunks = [arr[i * step: (i + 1) * step] for i in range(n_proc)]
    with ThreadPoolExecutor(n_proc) as pool:
        results = list(pool.map(lambda c: [func(x) for x in c], chunks))
    flat = [r for chunk in results for r in chunk]
    if target_data_type == "ndarray":
        return np.concatenate([np.asarray(f)[None] for f in flat], axis=0)
    return flat
