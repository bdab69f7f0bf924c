"""The device mesh of the port (port of ``dlrover_tpu/runtime/mesh.py``).

The reference builds one ``jax.sharding.Mesh`` over every device of the
job, with six named axes, and XLA inserts the collectives.  Here one
process drives one device, so the job's devices are the processes of the
default ``torch.distributed`` group, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over that group with the
same six axis names in the same order (outermost first)::

    data > fsdp > pipe > expert > seq > tensor

Every axis may be above 1: ``seq`` with Ulysses' all-to-alls
(``models/attention.ulysses_attention``) or ring attention's hops
(``parallel/ring_attention.py``), ``pipe`` with one pipeline stage a rank
(``parallel/pipeline.py``).  Each axis
above 1 has its process group (the
``DeviceMesh``'s ``get_group``) and its :class:`~dlrover_tpu_torch.
parallel.wire.Wire` (:func:`axis_wires`), through which every collective
of that axis goes.  A gloo world on one card puts every rank on
``cuda:0`` (the ``Wire`` stages the payloads through the host).  Where no
process group is initialized, :func:`single_device_mesh` is the world of
one process.  ``shard_map_compat`` and ``activate_mesh`` have no
counterpart: the port's collectives name their group explicitly, and the
mesh in use is the one the trainer or ``train_lib.build_train`` holds.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.common.log import default_logger as logger

# Mesh axis names, outermost (the data axis) to innermost.
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"

MESH_AXES: Tuple[str, ...] = (
    DATA_AXIS,
    FSDP_AXIS,
    PIPE_AXIS,
    EXPERT_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
)

#: The ROADMAP Queue 1 item that brings each model-parallel axis the port
#: does not run yet (none since item 9 brought ``pipe``).
_AXIS_ITEMS: Dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Degrees of each parallelism dimension: one named size per dim.
    ``data`` may be -1 meaning "use all remaining devices".  ``dcn_data``
    splits the data axis across hosts."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    dcn_data: int = 1

    def sizes(self, num_devices: int) -> Dict[str, int]:
        fixed = self.fsdp * self.pipe * self.expert * self.seq * self.tensor
        data = self.data
        if data == -1:
            if num_devices % fixed:
                raise ValueError(
                    f"{num_devices} devices not divisible by non-data "
                    f"parallel degree {fixed}"
                )
            data = num_devices // fixed
        total = data * fixed
        if total != num_devices:
            raise ValueError(
                f"parallel degrees {self} multiply to {total}, "
                f"but {num_devices} devices are available"
            )
        return {
            DATA_AXIS: data,
            FSDP_AXIS: self.fsdp,
            PIPE_AXIS: self.pipe,
            EXPERT_AXIS: self.expert,
            SEQ_AXIS: self.seq,
            TENSOR_AXIS: self.tensor,
        }

    @property
    def model_parallel_degree(self) -> int:
        return self.fsdp * self.pipe * self.expert * self.seq * self.tensor


@dataclasses.dataclass(frozen=True)
class SingleDeviceMesh:
    """The mesh of one process with no process group: every axis 1.  It
    answers what the trainer asks of a mesh (``mesh_dim_names``,
    ``shape``)."""

    mesh_dim_names: Tuple[str, ...] = MESH_AXES

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * len(self.mesh_dim_names)


def _dist_ready() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def process_count() -> int:
    """The processes of the default group (1 without one)."""
    return torch.distributed.get_world_size() if _dist_ready() else 1


def process_index() -> int:
    return torch.distributed.get_rank() if _dist_ready() else 0


def check_axes(sizes: Dict[str, int]) -> None:
    """Refuse an axis the port does not run yet above 1, naming its
    ROADMAP item."""
    for axis in _AXIS_ITEMS:
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"a {axis!r} axis of {sizes[axis]} is a later slice of the "
                f"port (ROADMAP Queue 1 item {_AXIS_ITEMS[axis]})"
            )


def build_mesh(config: ParallelConfig, device_type: str = "cuda"):
    """The job-wide mesh over the default process group, or
    :func:`single_device_mesh` where none is initialized.

    ``dcn_data`` must divide the data degree, as in the reference; the
    data axis is one group either way (which hosts it spans decides
    ``quantized_collectives.axis_crosses_dcn``)."""
    world = process_count()
    sizes = config.sizes(world)
    check_axes(sizes)
    if config.dcn_data > 1 and sizes[DATA_AXIS] % config.dcn_data:
        raise ValueError(
            f"data degree {sizes[DATA_AXIS]} not divisible by dcn_data "
            f"{config.dcn_data}"
        )
    if not _dist_ready():
        return single_device_mesh()
    from torch.distributed.device_mesh import DeviceMesh

    shape = [sizes[a] for a in MESH_AXES]
    if device_type == "cuda" and torch.cuda.device_count() == 1:
        # Every rank of a world on one card (gloo) sits on cuda:0.
        torch.cuda.set_device(0)
    mesh = DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=MESH_AXES)
    logger.info("built mesh %s over %d processes (%s, backend %s)",
                mesh_axis_sizes(mesh), world, device_type,
                torch.distributed.get_backend())
    return mesh


def single_device_mesh() -> SingleDeviceMesh:
    return SingleDeviceMesh()


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh (``{}`` for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_group(mesh):
    """The process group of the mesh's data axis (None at size 1)."""
    if mesh_axis_sizes(mesh).get(DATA_AXIS, 1) <= 1:
        return None
    return mesh.get_group(DATA_AXIS)


def mesh_coords(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """``{axis: coordinate}`` of process ``rank`` (default: this one) on
    the mesh: ranks are laid out row-major over :data:`MESH_AXES`, as
    :func:`build_mesh` arranges them."""
    sizes = mesh_axis_sizes(mesh)
    if not sizes:
        return {a: 0 for a in MESH_AXES}
    rank = process_index() if rank is None else rank
    out = {}
    for axis in reversed(mesh.mesh_dim_names):
        out[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return {a: out[a] for a in mesh.mesh_dim_names}


def axis_wires(mesh) -> Dict[str, object]:
    """One :class:`~dlrover_tpu_torch.parallel.wire.Wire` per mesh axis
    above 1, over that axis's process group, named by the axis."""
    from dlrover_tpu_torch.parallel.wire import Wire

    return {axis: Wire(mesh.get_group(axis), axis=axis)
            for axis, size in mesh_axis_sizes(mesh).items() if size > 1}


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of a named axis of ``mesh``; 1 when the axis is absent or no
    mesh is given."""
    return mesh_axis_sizes(mesh).get(axis, 1)


def factor_devices(
    n: int, priority: Sequence[str] = (TENSOR_AXIS, PIPE_AXIS, DATA_AXIS)
) -> Dict[str, int]:
    """Greedily split ``n`` devices over axes in ``priority`` order by
    round-robin assigning the smallest remaining prime factor.  Axes not in
    ``priority`` stay at 1; include ``"data"`` in ``priority`` for it to
    receive a share."""
    sizes = {a: 1 for a in MESH_AXES}
    remaining = n
    idx = 0
    while remaining > 1:
        p = _smallest_prime_factor(remaining)
        sizes[priority[idx]] *= p
        remaining //= p
        idx = (idx + 1) % len(priority)
    return sizes


def _smallest_prime_factor(n: int) -> int:
    for p in range(2, int(math.isqrt(n)) + 1):
        if n % p == 0:
            return p
    return n


def local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def slice_topology(group: Optional[object] = None) -> Dict:
    """What this process sees of the job: its platform and device, the
    process count and index, and how many hosts the processes span (the
    hosts' names are gathered over ``group``, the default group when
    None)."""
    platform = "gpu" if torch.cuda.is_available() else "cpu"
    info: Dict = {
        "platform": platform,
        "num_devices": process_count(),
        "num_local_devices": local_device_count(),
        "num_hosts": len(set(host_names(group))),
        "host_index": process_index(),
    }
    if platform == "gpu":
        info["device_kind"] = torch.cuda.get_device_name(0)
    return info


def host_names(group: Optional[object] = None) -> Tuple[str, ...]:
    """Every member's host name, in rank order (one collective)."""
    name = socket.gethostname()
    if not _dist_ready():
        return (name,)
    out = [None] * torch.distributed.get_world_size(group)
    torch.distributed.all_gather_object(out, name, group=group)
    return tuple(out)
