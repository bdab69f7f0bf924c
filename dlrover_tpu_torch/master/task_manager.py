"""Dynamic data sharding: split datasets into shards, reassign on failure
(port of ``dlrover_tpu/master/task_manager.py``).

Capability ref: ``dlrover/python/master/shard/task_manager.py:37-292`` +
``shard/dataset_splitter.py`` (``TableDatasetSplitter``,
``TextDatasetSplitter``, ``StreamingDatasetSplitter``) +
``batch_dataset_manager.py`` (pending/doing queues, ``recover_tasks``,
timeout reassignment, shard checkpoint/restore).

The design carries over cleanly because it is pure host-side
control plane: shards are [start, end) ranges of a global sample index space;
the trainer's per-host dataloader asks for the next shard instead of using a
static partition, so a resized world automatically rebalances and a dead
host's in-flight shards requeue.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.messages import (
    DatasetShardParams,
    ShardCheckpoint,
    ShardTask,
)

_TASK_TIMEOUT = 1800.0


class DatasetSplitter:
    """Produces epoch-by-epoch lists of shards."""

    def __init__(self, params: DatasetShardParams):
        self.params = params
        self.epoch = 0

    def create_shards(self) -> List[ShardTask]:
        p = self.params
        shards = []
        num = (p.dataset_size + p.shard_size - 1) // p.shard_size
        order = list(range(num))
        if p.shuffle:
            import random

            random.Random(self.epoch).shuffle(order)
        for i in order:
            start = i * p.shard_size
            end = min(start + p.shard_size, p.dataset_size)
            shards.append(
                ShardTask(
                    dataset_name=p.dataset_name,
                    start=start,
                    end=end,
                    epoch=self.epoch,
                )
            )
        self.epoch += 1
        return shards

    def epoch_finished(self) -> bool:
        return self.epoch >= self.params.num_epochs


_MAX_SHARD_COUNT = 50_000


class TableDatasetSplitter(DatasetSplitter):
    """Record-range shards over a bounded table (capability ref
    ``dataset_splitter.py:144-257`` TableDatasetSplitter): shards are
    [start, end) row ranges, epochs reshuffle the shard ORDER (never the
    rows inside a shard — a shard is the reader's sequential-scan unit).

    Huge datasets (ref ``_split_epoch_for_huge_dataset:180-196``): when
    one epoch would materialize more than ``max_shard_count`` shards, the
    epoch is split into subepochs covering consecutive row windows of at
    most ``max_shard_count * shard_size`` rows each — the master holds a
    bounded shard list regardless of dataset size.  ``num_epochs``
    multiplies by the subepoch count internally; :meth:`user_epoch` maps
    back to the caller's epoch numbering.
    """

    def __init__(self, params: DatasetShardParams):
        super().__init__(params)
        self.max_shard_count = params.max_shard_count or _MAX_SHARD_COUNT
        p = self.params
        shard_count = (p.dataset_size + p.shard_size - 1) // p.shard_size
        self._subepochs_per_epoch = 0
        self._total_epochs = p.num_epochs
        if shard_count > self.max_shard_count:
            self._subepochs_per_epoch = -(-shard_count // self.max_shard_count)
            self._total_epochs = p.num_epochs * self._subepochs_per_epoch
            logger.info(
                "dataset %s: %d shards/epoch > max %d; splitting each "
                "epoch into %d subepochs",
                p.dataset_name, shard_count, self.max_shard_count,
                self._subepochs_per_epoch,
            )

    def user_epoch(self) -> int:
        """The caller-visible epoch (ref ``get_epoch:188``)."""
        if self._subepochs_per_epoch:
            return self.epoch // self._subepochs_per_epoch
        return self.epoch

    def _window(self) -> Tuple[int, int]:
        """The [lo, hi) row range the current (sub)epoch covers."""
        p = self.params
        if not self._subepochs_per_epoch:
            return 0, p.dataset_size
        subepoch_idx = self.epoch % self._subepochs_per_epoch
        subepoch_rows = self.max_shard_count * p.shard_size
        lo = subepoch_idx * subepoch_rows
        return lo, min(lo + subepoch_rows, p.dataset_size)

    def create_shards(self) -> List[ShardTask]:
        p = self.params
        if not self._subepochs_per_epoch:
            return super().create_shards()
        lo, hi = self._window()
        order = list(range(lo, hi, p.shard_size))
        if p.shuffle:
            import random

            random.Random(self.epoch).shuffle(order)
        shards = [
            ShardTask(
                dataset_name=p.dataset_name,
                start=start,
                end=min(start + p.shard_size, hi),
                epoch=self.user_epoch(),
            )
            for start in order
        ]
        self.epoch += 1
        return shards

    def epoch_finished(self) -> bool:
        return self.epoch >= self._total_epochs


class TextDatasetSplitter(TableDatasetSplitter):
    """Line-index shards over a text file (capability ref
    ``dataset_splitter.py:257-324`` TextDatasetSplitter): ``dataset_size``
    is the line count.  Under ``shuffle`` each shard carries explicit
    ``record_indices`` drawn from a permutation of line numbers —
    sample-level shuffling, not just shard-order shuffling (a
    line-addressable file has no sequential-scan constraint, unlike the
    table case).  The trainer-side
    :class:`dlrover_tpu_torch.data.text_shards.TextShardReader` resolves
    indices through its byte-offset index, so random line access costs
    one seek, never a scan from the top.

    Inherits the table splitter's subepoch machinery, so the permutation
    (and with it every shard's index payload and the master's shard-
    checkpoint size) is bounded by the ``max_shard_count`` window — a
    huge corpus shuffles within consecutive windows instead of
    materializing an O(dataset_size) permutation in master memory.

    Without ``shuffle`` shards are plain [start, end) line ranges read
    sequentially, capped to whole lines so a short final shard is emitted
    rather than padding past EOF.
    """

    def create_shards(self) -> List[ShardTask]:
        p = self.params
        if not p.shuffle:
            return super().create_shards()
        import random

        lo, hi = self._window()
        indices = list(range(lo, hi))
        random.Random(self.epoch).shuffle(indices)
        shards = []
        for offset in range(0, hi - lo, p.shard_size):
            start = lo + offset
            end = min(start + p.shard_size, hi)
            shards.append(
                ShardTask(
                    dataset_name=p.dataset_name,
                    start=start,
                    end=end,
                    epoch=self.user_epoch(),
                    record_indices=indices[offset:offset + (end - start)],
                )
            )
        self.epoch += 1
        return shards


class StreamingDatasetSplitter(DatasetSplitter):
    """Unbounded stream: keeps emitting fixed-size shards forever
    (capability ref ``dataset_splitter.py:359`` StreamingDatasetSplitter)."""

    def __init__(self, params: DatasetShardParams):
        super().__init__(params)
        self._next_start = 0

    def create_shards(self) -> List[ShardTask]:
        p = self.params
        shards = []
        for _ in range(64):  # refill window
            shards.append(
                ShardTask(
                    dataset_name=p.dataset_name,
                    start=self._next_start,
                    end=self._next_start + p.shard_size,
                    epoch=0,
                )
            )
            self._next_start += p.shard_size
        return shards

    def epoch_finished(self) -> bool:
        return False


def make_splitter(params: DatasetShardParams) -> DatasetSplitter:
    """ref ``dataset_splitter.py``'s factory: table | text | stream."""
    if params.storage_type == "stream":
        return StreamingDatasetSplitter(params)
    if params.storage_type == "text":
        return TextDatasetSplitter(params)
    return TableDatasetSplitter(params)


class DatasetManager:
    def __init__(self, splitter: DatasetSplitter):
        self.splitter = splitter
        self.pending: Deque[ShardTask] = deque()
        self.doing: "OrderedDict[int, Tuple[int, ShardTask, float]]" = (
            OrderedDict()
        )
        self._next_task_id = 0
        self._completed = 0

    def refill_if_empty(self):
        if not self.pending and not self.splitter.epoch_finished():
            for shard in self.splitter.create_shards():
                shard.task_id = self._next_task_id
                self._next_task_id += 1
                self.pending.append(shard)

    def get_task(self, node_id: int) -> ShardTask:
        self.refill_if_empty()
        if not self.pending:
            return ShardTask()  # empty: dataset exhausted
        task = self.pending.popleft()
        self.doing[task.task_id] = (node_id, task, time.monotonic())
        return task

    def report_task(self, task_id: int, success: bool) -> bool:
        entry = self.doing.pop(task_id, None)
        if entry is None:
            return False
        if success:
            self._completed += 1
        else:
            self.pending.appendleft(entry[1])
        return True

    def recover_tasks(self, node_id: int):
        """Requeue all in-flight shards of a dead host (ref
        ``task_manager.recover_tasks:165``)."""
        requeued = []
        for task_id, (owner, task, _) in list(self.doing.items()):
            if owner == node_id:
                del self.doing[task_id]
                self.pending.appendleft(task)
                requeued.append(task_id)
        if requeued:
            logger.info(
                "requeued %d shards of dead node %d", len(requeued), node_id
            )

    def reassign_timeout_tasks(self, timeout: float = _TASK_TIMEOUT):
        now = time.monotonic()
        for task_id, (owner, task, started) in list(self.doing.items()):
            if now - started > timeout:
                del self.doing[task_id]
                self.pending.appendleft(task)
                logger.warning(
                    "shard %d timed out on node %d; requeued", task_id, owner
                )

    def finished(self) -> bool:
        return (
            not self.pending
            and not self.doing
            and self.splitter.epoch_finished()
        )

    def checkpoint(self) -> Dict:
        """Uncompleted = pending + doing; both restart from scratch on resume
        (ref ``task_manager.get_dataset_checkpoint:243``)."""
        todo = [
            (t.start, t.end, t.epoch, t.record_indices)
            for t in list(self.pending)
            + [task for _, task, _ in self.doing.values()]
        ]
        return {
            "dataset": self.splitter.params.dataset_name,
            "todo": todo,
            "epoch": self.splitter.epoch,
            "completed": self._completed,
        }

    def restore(self, state: Dict):
        self.pending.clear()
        self.doing.clear()
        for entry in state.get("todo", []):
            # Pre-r5 checkpoints carry (start, end, epoch) triples; newer
            # ones append the text splitter's record_indices.
            start, end, epoch = entry[:3]
            indices = entry[3] if len(entry) > 3 else None
            shard = ShardTask(
                task_id=self._next_task_id,
                dataset_name=self.splitter.params.dataset_name,
                start=start,
                end=end,
                epoch=epoch,
                record_indices=list(indices) if indices else None,
            )
            self._next_task_id += 1
            self.pending.append(shard)
        self.splitter.epoch = state.get("epoch", 0)
        self._completed = state.get("completed", 0)


class TaskManager:
    """All datasets of one job + the timeout-reassignment loop."""

    def __init__(self):
        self._lock = threading.Lock()
        self._datasets: Dict[str, DatasetManager] = {}
        self._worker_last_report: Dict[int, float] = {}

    def create_dataset(self, params: DatasetShardParams):
        with self._lock:
            if params.dataset_name not in self._datasets:
                self._datasets[params.dataset_name] = DatasetManager(
                    make_splitter(params)
                )
                logger.info(
                    "created dataset %s: size=%d shard=%d epochs=%d",
                    params.dataset_name, params.dataset_size,
                    params.shard_size, params.num_epochs,
                )

    def get_task(self, dataset_name: str, node_id: int) -> ShardTask:
        with self._lock:
            manager = self._datasets.get(dataset_name)
            if manager is None:
                return ShardTask()
            self._worker_last_report[node_id] = time.monotonic()
            return manager.get_task(node_id)

    def report_task(
        self, dataset_name: str, task_id: int, success: bool
    ) -> bool:
        with self._lock:
            manager = self._datasets.get(dataset_name)
            return manager.report_task(task_id, success) if manager else False

    def recover_tasks(self, node_id: int):
        with self._lock:
            for manager in self._datasets.values():
                manager.recover_tasks(node_id)

    def reassign_timeout_tasks(self):
        with self._lock:
            for manager in self._datasets.values():
                manager.reassign_timeout_tasks()

    def finished(self, dataset_name: str) -> bool:
        with self._lock:
            manager = self._datasets.get(dataset_name)
            return manager.finished() if manager else True

    def checkpoint(self, dataset_name: str) -> ShardCheckpoint:
        with self._lock:
            manager = self._datasets.get(dataset_name)
            content = json.dumps(manager.checkpoint()) if manager else "{}"
            return ShardCheckpoint(dataset_name, content)

    def restore(self, ckpt: ShardCheckpoint):
        with self._lock:
            manager = self._datasets.get(ckpt.dataset_name)
            if manager and ckpt.content:
                manager.restore(json.loads(ckpt.content))

    def worker_progressing(self, window: float = 1800.0) -> bool:
        """Any shard-fetch activity inside the hang-detection window?"""
        with self._lock:
            if not self._worker_last_report:
                return True
            return (
                time.monotonic() - max(self._worker_last_report.values())
                < window
            )
