"""Serving plane: continuous-batching decode on the training model.

The same parameters that train also serve, through the slotted KV cache
in :mod:`dlrover_tpu_torch.serving.decode` and the host-side scheduler in
:mod:`dlrover_tpu_torch.serving.engine`.
"""

from dlrover_tpu_torch.serving.bucketing import (  # noqa: F401
    make_buckets,
    pad_to_bucket,
    pick_bucket,
)
from dlrover_tpu_torch.serving.decode import (  # noqa: F401
    ServePrograms,
    sample_tokens,
)
from dlrover_tpu_torch.serving.engine import (  # noqa: F401
    Request,
    RequestResult,
    ServingEngine,
)
