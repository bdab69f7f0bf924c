"""Serving plane: continuous-batching decode on the training model.

The same parameters that train also serve, through the slotted KV cache
in :mod:`dlrover_tpu_torch.serving.decode` and the host-side scheduler in
:mod:`dlrover_tpu_torch.serving.engine`; speculative decoding and
disaggregated prefill ride the engine, a tensor-parallel fold
(:mod:`~dlrover_tpu_torch.serving.tp`) splits one model over processes,
replicas form a
:class:`ReplicaFleet` behind a :class:`ServeFrontend`, and
:mod:`~dlrover_tpu_torch.serving.hotswap` swaps weights live.
"""

from dlrover_tpu_torch.serving.bucketing import (  # noqa: F401
    make_buckets,
    pad_to_bucket,
    pick_bucket,
)
from dlrover_tpu_torch.serving.decode import (  # noqa: F401
    MAX_SPEC_TOKENS,
    ServePrograms,
    SpecPrograms,
    clear_programs,
    get_programs,
    get_spec_programs,
    sample_tokens,
)
from dlrover_tpu_torch.serving.draft import make_draft  # noqa: F401
from dlrover_tpu_torch.serving.engine import (  # noqa: F401
    ROLES,
    PrefilledPage,
    Request,
    RequestResult,
    ServingEngine,
)
from dlrover_tpu_torch.serving.fleet import (  # noqa: F401
    NoReplicaError,
    ReplicaFleet,
)
from dlrover_tpu_torch.serving.frontend import ServeFrontend  # noqa: F401
from dlrover_tpu_torch.serving.tp import (  # noqa: F401
    ServeTPMesh,
    build_tp_mesh,
    fold_width,
)
