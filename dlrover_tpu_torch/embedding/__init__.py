"""The embedding plane (port of ``dlrover_tpu/embedding``): host store,
spill tier, sharded plane, and the device hot-row cache whose gather and
scatter are the CUDA kernels of ``ops/csrc/embedding_rows.cu``."""

from dlrover_tpu_torch.embedding.table import EmbeddingTable  # noqa: F401
from dlrover_tpu_torch.embedding.store import KVStore  # noqa: F401
from dlrover_tpu_torch.embedding.sharded import (  # noqa: F401
    ShardedEmbeddingTable,
    hash_bucket,
)
from dlrover_tpu_torch.embedding.device_cache import (  # noqa: F401
    DeviceHotRowCache,
    EmbeddingPrefetcher,
)
