"""Worker-side dynamic data shard consumption (port of
``dlrover_tpu/data/sharding_client.py``, whole).

Capability ref: ``dlrover/python/elastic_agent/sharding/client.py:29-319``
(``ShardingClient.fetch_shard:190``, ``report_batch_done:144``,
``IndexShardingClient:231``).

The trainer asks the master for [start, end) sample ranges instead of using a
static partition; completed shards are acked so a resized/restarted world
resumes exactly where the data stream left off (pairs with the master's
TaskManager shard checkpoint).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Iterator, Optional

from dlrover_tpu_torch.master.messages import DatasetShardParams, ShardTask


def task_sample_indices(task: ShardTask):
    """The sample indices a shard denotes: explicit ``record_indices``
    (the shuffled text splitter's per-shard permutation slice) win over
    the [start, end) range — every consumer must resolve shards through
    this, or master-side sample shuffling silently becomes a no-op."""
    indices = getattr(task, "record_indices", None)
    if indices:
        return list(indices)
    return range(task.start, task.end)


class ShardingClient:
    """Fetch/ack shard tasks for one dataset."""

    def __init__(
        self,
        master_client,
        dataset_name: str,
        dataset_size: int = 0,
        shard_size: int = 0,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
        create: bool = True,
    ):
        self._client = master_client
        self.dataset_name = dataset_name
        if create and dataset_size > 0:
            self._client.create_dataset(
                DatasetShardParams(
                    dataset_name=dataset_name,
                    dataset_size=dataset_size,
                    shard_size=shard_size or max(1, dataset_size // 64),
                    num_epochs=num_epochs,
                    shuffle=shuffle,
                    storage_type=storage_type,
                )
            )
        self._current: Optional[ShardTask] = None

    def fetch_shard(self) -> Optional[ShardTask]:
        task = self._client.get_task(self.dataset_name)
        if task is None or task.empty:
            return None
        self._current = task
        return task

    def report_shard_done(self, task: Optional[ShardTask] = None):
        task = task or self._current
        if task is not None:
            self._client.report_task(self.dataset_name, task.task_id, True)

    def shard_indices(self) -> Iterator[int]:
        """Iterate sample indices across shards until the dataset drains."""
        while True:
            task = self.fetch_shard()
            if task is None:
                return
            yield from task_sample_indices(task)
            self.report_shard_done(task)


class IndexShardingClient(ShardingClient):
    """Per-sample index stream with batch-level acking
    (ref ``IndexShardingClient:231``: report_batch_done)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lock = threading.Lock()
        self._pending: Deque[int] = deque()
        self._inflight: Deque[ShardTask] = deque()
        self._consumed_of_shard = 0

    def fetch_sample_index(self) -> Optional[int]:
        with self._lock:
            if not self._pending:
                task = self.fetch_shard()
                if task is None:
                    return None
                self._inflight.append(task)
                self._pending.extend(task_sample_indices(task))
            return self._pending.popleft()

    def report_batch_done(self, batch_size: int):
        """Ack shards fully consumed by the last ``batch_size`` samples."""
        with self._lock:
            self._consumed_of_shard += batch_size
            while self._inflight:
                head = self._inflight[0]
                size = head.end - head.start
                if self._consumed_of_shard >= size:
                    self._consumed_of_shard -= size
                    self._inflight.popleft()
                    self.report_shard_done(head)
                else:
                    break
