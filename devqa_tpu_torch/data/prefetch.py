"""Background-prefetching batch generator (counterpart of ``devqa_tpu/data/prefetch.py``).

A producer thread organizes batches into a bounded queue while the
training step consumes them, overlapping host-side batch organization
(tokenization, image encoding, sampling) with device compute. One
iteration is one epoch; shuffling is seeded and deterministic per epoch.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np


class ParallelDataset:
    def __init__(
        self,
        sample_count: int,
        get_data_by_ids: Callable[[List[int]], object],
        batch_size: int,
        shuffle: bool = True,
        buffer_size: int = 8,
        drop_last: bool = True,
        seed: Optional[int] = None,
    ):
        self.sample_count = sample_count
        self.get_data_by_ids = get_data_by_ids
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.buffer_size = buffer_size
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.epoch = 0

    def _epoch_id_batches(self) -> List[List[int]]:
        ids = np.arange(self.sample_count)
        if self.shuffle:
            self.rng.shuffle(ids)
        batches = []
        for i in range(0, len(ids), self.batch_size):
            chunk = ids[i:i + self.batch_size].tolist()
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            batches.append(chunk)
        return batches

    def __iter__(self) -> Iterator[Tuple[object, int]]:
        """Yields (organized_batch, n_samples) for one epoch, with a
        background producer thread keeping ``buffer_size`` batches ready.
        An error in the producer is raised in the consumer."""
        id_batches = self._epoch_id_batches()
        self.epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # A bounded put with a stop check: when the consumer abandons
            # the iterator (max_steps or an early stop mid-epoch), a plain
            # put would block forever and the thread would go on
            # organizing batches beside whatever the trainer does next.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for ids in id_batches:
                    if not put((self.get_data_by_ids(ids), len(ids))):
                        return
            except BaseException as e:  # handed to the consumer, re-raised there
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # Normal return or abandonment (GeneratorExit) both land here.
            stop.set()
