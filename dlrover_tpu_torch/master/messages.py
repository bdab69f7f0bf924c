"""Control-plane messages (port of parts of ``dlrover_tpu/master/
messages.py``): ``DatasetShardParams`` and ``ShardTask``, which
``data/sharding_client.py`` speaks to the master, and the serving front
door's ``ServeSubmit``, ``ServeTicket``, ``ServePoll``, ``ServeStatus`` and
``ServeCancel`` (``serving/frontend.py``).  The rest of the reference
file, the envelope, its restricted unpickler and the other control-plane
messages, belongs to the master and the agent (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


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


# -- serving front door -------------------------------------------------------


@dataclasses.dataclass
class ServeSubmit:
    """One generation request through the front door.  The prompt is a
    tuple of token ids (builtins only); ``deadline_s`` is the client's
    end-to-end budget, which the admission controller sheds against."""

    uid: str
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1
    deadline_s: float = 30.0


@dataclasses.dataclass
class ServeTicket:
    """Submit verdict: accepted into the bounded queue, or fast-rejected
    (``reason`` = "shed" | "queue_full" | "no_fleet" | "invalid: ...")
    with the predicted wait that triggered the shed."""

    uid: str
    accepted: bool
    reason: str = ""
    predicted_wait_s: float = 0.0


@dataclasses.dataclass
class ServePoll:
    uid: str


@dataclasses.dataclass
class ServeStatus:
    """Poll answer.  ``state`` walks pending -> done; ``tokens`` are the
    generated ids once done; shed/cancelled/unknown are terminal."""

    uid: str
    state: str = "unknown"
    tokens: Tuple[int, ...] = ()
    latency_s: float = 0.0


@dataclasses.dataclass
class ServeCancel:
    uid: str
