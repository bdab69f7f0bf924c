"""Data-sharding messages (port of ``DatasetShardParams`` and ``ShardTask``
of ``dlrover_tpu/master/messages.py``).

``data/sharding_client.py`` speaks them to the master.  The rest of the
reference file, the envelope and the other control-plane messages, belongs
to the master and the agent (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class DatasetShardParams:
    dataset_name: str
    dataset_size: int
    shard_size: int
    num_epochs: int = 1
    shuffle: bool = False
    storage_type: str = "table"  # table | text | stream
    batch_size: int = 0
    # OOM guard (ref ``dataset_splitter.py`` _MAX_SHARD_COUNT): an epoch
    # producing more shards than this is split into subepochs of at most
    # this many shards, so the master never materializes an unbounded
    # shard list for a huge dataset.  0 = library default.
    max_shard_count: int = 0


@dataclasses.dataclass
class ShardTask:
    task_id: int = -1
    dataset_name: str = ""
    start: int = 0
    end: int = 0
    epoch: int = 0
    record_indices: Optional[List[int]] = None

    @property
    def empty(self) -> bool:
        return self.task_id < 0
