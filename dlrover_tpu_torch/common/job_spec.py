"""Declarative job specification: the third config tier (port of
``dlrover_tpu/common/job_spec.py``).

Capability ref: ``dlrover/go/operator/api/v1alpha1/elasticjob_types.go:29-127``
— the reference declares jobs as a CRD spec (replica ranges, distribution
strategy, optimize mode, resource limits) that drives the master; CLI
flags and the runtime paral-config are the other two tiers.

Redesign: no k8s, so the spec is a versioned TOML/YAML/JSON file
loaded by ``run.py --job-spec`` (and usable by a cloud master directly).
Precedence matches the reference's operator semantics: spec < explicit
CLI flags (flags are the operator's own overrides), and the runtime
paral-config tier keeps live-tunable knobs out of both.

The field set is the TPU-relevant projection of the CRD: replica ranges
-> node min/max/unit; pod template -> accelerator type / runtime version
/ preemptible + trainer command; optimize mode -> brain thresholds;
resource limits are per-VM on TPU (the accelerator type IS the resource
class), so they collapse into the accelerator section.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List

SUPPORTED_API_VERSIONS = ("dlrover-tpu/v1",)


class JobSpecError(ValueError):
    """Malformed / unsupported job spec."""


@dataclasses.dataclass
class NodeSpec:
    """Replica range (ref ``elasticjob_types.go`` ReplicaSpecs)."""

    min: int = 1
    max: int = 1
    unit: int = 1  # world size multiple (slice granularity)
    # Auxiliary typed pool (ref the PS/worker typed replica specs):
    # data-preprocessing coworker hosts supervised/repaired beside the
    # trainers but outside the rendezvous and the auto-scaler.
    coworkers: int = 0


@dataclasses.dataclass
class AcceleratorSpec:
    """The VM class to actuate (ref pod template resources)."""

    type: str = "v5litepod-8"
    runtime_version: str = "tpu-ubuntu2204-base"
    preemptible: bool = False
    project: str = ""   # empty -> env/metadata resolution (tpu_api.py)
    zone: str = ""


@dataclasses.dataclass
class MasterSpec:
    heartbeat_timeout: float = 60.0
    hang_threshold: float = 0.0
    optimize_interval_s: float = 300.0
    rdzv_waiting_timeout: float = 60.0
    max_relaunches: int = 3
    state_path: str = ""


@dataclasses.dataclass
class BrainSpec:
    """Observation-driven sizing thresholds (ref optimize mode +
    ``go/brain`` optimizer config)."""

    uplift_threshold: float = 1.1
    degrade_threshold: float = 0.7
    patience: int = 3
    stale_after_s: float = 3600.0


@dataclasses.dataclass
class CheckpointSpec:
    dir: str = ""
    every: int = 100
    keep: int = 3
    save_at_breakpoint: bool = False


@dataclasses.dataclass
class FaultsSpec:
    """Faultline chaos plan for the whole job (see common/faults.py).

    ``plan`` uses the ``DLROVER_TPU_FAULTS`` grammar
    (``"storage.write:error@3;rpc.report:delay=2.0@5,7"``); the master/agent
    export it into every child process so one spec drives a deterministic
    chaos run end to end.
    """

    plan: str = ""
    seed: int = 0


@dataclasses.dataclass
class TrainerSpec:
    command: List[str] = dataclasses.field(default_factory=list)
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    max_restarts: int = 3
    monitor_interval: float = 5.0
    heartbeat_interval: float = 15.0
    network_check: bool = False
    device_init_timeout: float = 900.0


@dataclasses.dataclass
class ElasticJobSpec:
    """The whole declarative job (versioned)."""

    api_version: str = SUPPORTED_API_VERSIONS[-1]
    job_name: str = "job"
    nodes: NodeSpec = dataclasses.field(default_factory=NodeSpec)
    accelerator: AcceleratorSpec = dataclasses.field(
        default_factory=AcceleratorSpec
    )
    master: MasterSpec = dataclasses.field(default_factory=MasterSpec)
    brain: BrainSpec = dataclasses.field(default_factory=BrainSpec)
    checkpoint: CheckpointSpec = dataclasses.field(
        default_factory=CheckpointSpec
    )
    trainer: TrainerSpec = dataclasses.field(default_factory=TrainerSpec)
    faults: FaultsSpec = dataclasses.field(default_factory=FaultsSpec)

    def validate(self) -> "ElasticJobSpec":
        if self.api_version not in SUPPORTED_API_VERSIONS:
            raise JobSpecError(
                f"unsupported api_version {self.api_version!r} "
                f"(supported: {SUPPORTED_API_VERSIONS})"
            )
        n = self.nodes
        if not (1 <= n.min <= n.max):
            raise JobSpecError(
                f"nodes.min/max must satisfy 1 <= min <= max, got "
                f"{n.min}/{n.max}"
            )
        if n.unit < 1 or n.max % n.unit:
            raise JobSpecError(
                f"nodes.unit {n.unit} must divide nodes.max {n.max}"
            )
        if not self.job_name:
            raise JobSpecError("job_name must be non-empty")
        if self.faults.plan:
            # Parse eagerly: a malformed chaos plan must fail at spec load,
            # not hours later when the first scheduled fault would fire.
            from dlrover_tpu_torch.common import faults as _faults

            try:
                _faults.parse_plan(self.faults.plan)
            except ValueError as e:
                raise JobSpecError(f"[faults].plan invalid: {e}") from e
        coerced = {}
        for key, value in self.trainer.env.items():
            # TOML/YAML naturally parse `OMP_NUM_THREADS = 4` as an int;
            # os.environ only takes strings — coerce scalars, reject
            # structures with an error that names the key.
            if isinstance(value, bool):
                value = "1" if value else "0"
            elif isinstance(value, (int, float, str)):
                value = str(value)
            else:
                raise JobSpecError(
                    f"[trainer].env.{key} must be a scalar, got "
                    f"{type(value).__name__}"
                )
            coerced[str(key)] = value
        self.trainer.env = coerced
        return self


_SECTIONS = {
    "nodes": NodeSpec,
    "accelerator": AcceleratorSpec,
    "master": MasterSpec,
    "brain": BrainSpec,
    "checkpoint": CheckpointSpec,
    "trainer": TrainerSpec,
    "faults": FaultsSpec,
}


def _build_section(cls, data: Dict[str, Any], path: str):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        # Unknown keys are errors, not warnings: a typo'd knob silently
        # running with its default is the worst failure mode a config
        # tier can have.
        raise JobSpecError(
            f"unknown key(s) {sorted(unknown)} in [{path}] "
            f"(valid: {sorted(fields)})"
        )
    return cls(**data)


def spec_from_dict(data: Dict[str, Any]) -> ElasticJobSpec:
    data = dict(data)
    kwargs: Dict[str, Any] = {}
    for key in ("api_version", "job_name"):
        if key in data:
            kwargs[key] = data.pop(key)
    for section, cls in _SECTIONS.items():
        if section in data:
            payload = data.pop(section)
            if not isinstance(payload, dict):
                raise JobSpecError(f"[{section}] must be a table/mapping")
            kwargs[section] = _build_section(cls, payload, section)
    if data:
        raise JobSpecError(
            f"unknown top-level key(s) {sorted(data)} "
            f"(valid: api_version, job_name, {sorted(_SECTIONS)})"
        )
    return ElasticJobSpec(**kwargs).validate()


def load_job_spec(path: str) -> ElasticJobSpec:
    """Parse a spec file by extension: .toml | .yaml/.yml | .json."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        raw = f.read()
    if ext == ".toml":
        import tomllib

        data = tomllib.loads(raw.decode())
    elif ext in (".yaml", ".yml"):
        try:
            import yaml
        except ModuleNotFoundError as e:
            # No fall-through to another parser: a YAML file read as
            # something else could load with the wrong values.
            raise JobSpecError(
                f"{path}: a .yaml spec needs the 'yaml' package (pyyaml), "
                "which is not installed; use .toml or .json"
            ) from e

        data = yaml.safe_load(raw)
    elif ext == ".json":
        data = json.loads(raw)
    else:
        raise JobSpecError(
            f"unsupported spec format {ext!r} (use .toml/.yaml/.json)"
        )
    if not isinstance(data, dict):
        raise JobSpecError("spec root must be a table/mapping")
    return spec_from_dict(data)


def spec_to_dict(spec: ElasticJobSpec) -> Dict[str, Any]:
    return dataclasses.asdict(spec)
