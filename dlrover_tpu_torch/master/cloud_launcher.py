"""Cloud NodeLauncher: GCE TPU-VM actuation behind the launcher seam (port
of ``dlrover_tpu/master/cloud_launcher.py``).

Capability ref: ``dlrover/python/master/scaler/pod_scaler.py:78-662``
(``_create_pod:441``, ``_periodic_create_pod:414``, the pending-creation
queue and relaunch-on-failure flow) and the Go operator's node actuation
(``dlrover/go/operator/pkg/controllers/elasticjob_controller.go``).

TPU redesign: the schedulable unit is a TPU VM (one host of a slice, or a
whole single-host slice), created through the Cloud TPU API.  The concrete
HTTP client is injected behind :class:`TpuVmClient` so tests drive the
launcher against :class:`FakeTpuVmClient` exactly the way the reference
mocks the k8s client (``dlrover/python/tests/test_utils.py:200-295``
``mock_k8s_client``).  Only the thin client would talk to
``tpu.googleapis.com`` in production; everything above it — naming, retry,
pending-queue, reconciliation — is covered by the fake-backed tests.

Creation is asynchronous on real clouds: ``launch`` enqueues and returns;
a background creator thread (ref ``_periodic_create_pod``) drains the
queue with retry, and ``reconcile()`` maps cloud instance states back onto
the NodeManager inventory (the Watcher role — here a poll, since TPU VMs
have no event stream equivalent to pod watches).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.retry import RetryAborted, RetryError, RetryPolicy
from dlrover_tpu_torch.master.node_manager import NodeLauncher


class TpuVmState:
    CREATING = "CREATING"
    READY = "READY"
    PREEMPTED = "PREEMPTED"
    TERMINATED = "TERMINATED"


class TpuVmClient:
    """Thin Cloud TPU API surface (nodes.create/delete/list/get).

    Mirrors ``projects.locations.nodes`` of ``tpu.googleapis.com`` v2 at
    the granularity the launcher needs.  Implementations raise
    ``CloudError`` on API failures.  Production:
    :class:`dlrover_tpu_torch.master.tpu_api.TpuVmHttpClient` (HTTP +
    metadata-server auth); tests: :class:`FakeTpuVmClient`.
    """

    def create_node(self, name: str, accelerator_type: str,
                    runtime_version: str, metadata: Dict[str, str]) -> None:
        raise NotImplementedError

    def delete_node(self, name: str) -> None:
        raise NotImplementedError

    def get_node(self, name: str) -> Optional[Dict]:
        raise NotImplementedError

    def list_nodes(self) -> List[Dict]:
        raise NotImplementedError


class CloudError(RuntimeError):
    """Cloud API failure (quota, stockout, transient 5xx)."""


class FakeTpuVmClient(TpuVmClient):
    """In-memory cloud: the test seam (ref ``mock_k8s_client``).

    Instances advance CREATING -> READY after ``provision_delay_s`` (0 for
    instant tests); ``fail_next(n)`` injects n consecutive create failures
    (quota/stockout), ``preempt(name)`` flips a VM to PREEMPTED — the two
    failure modes the launcher must survive.
    """

    def __init__(self, provision_delay_s: float = 0.0):
        self.provision_delay_s = provision_delay_s
        self._mu = threading.Lock()
        self.instances: Dict[str, Dict] = {}
        self.create_calls: List[str] = []
        self.delete_calls: List[str] = []
        self._fail_creates = 0

    def fail_next(self, n: int = 1):
        with self._mu:
            self._fail_creates = n

    def preempt(self, name: str):
        with self._mu:
            if name in self.instances:
                self.instances[name]["state"] = TpuVmState.PREEMPTED

    def _advance(self, inst: Dict):
        if inst["state"] == TpuVmState.CREATING and (
            time.monotonic() - inst["created_at"] >= self.provision_delay_s
        ):
            inst["state"] = TpuVmState.READY

    def create_node(self, name, accelerator_type, runtime_version, metadata):
        with self._mu:
            self.create_calls.append(name)
            if self._fail_creates > 0:
                self._fail_creates -= 1
                raise CloudError("RESOURCE_EXHAUSTED: no capacity")
            if name in self.instances and (
                self.instances[name]["state"] != TpuVmState.TERMINATED
            ):
                raise CloudError(f"ALREADY_EXISTS: {name}")
            self.instances[name] = {
                "name": name,
                "accelerator_type": accelerator_type,
                "runtime_version": runtime_version,
                "metadata": dict(metadata),
                "state": TpuVmState.CREATING,
                "created_at": time.monotonic(),
            }

    def delete_node(self, name):
        with self._mu:
            self.delete_calls.append(name)
            inst = self.instances.get(name)
            if inst is None:
                raise CloudError(f"NOT_FOUND: {name}")
            inst["state"] = TpuVmState.TERMINATED

    def get_node(self, name):
        with self._mu:
            inst = self.instances.get(name)
            if inst is None:
                return None
            self._advance(inst)
            return dict(inst)

    def list_nodes(self):
        with self._mu:
            for inst in self.instances.values():
                self._advance(inst)
            return [dict(i) for i in self.instances.values()
                    if i["state"] != TpuVmState.TERMINATED]


class CloudNodeLauncher(NodeLauncher):
    """TPU-VM creating launcher (the pod_scaler equivalent).

    ``launch`` enqueues; the creator thread drains with bounded retry (ref
    ``_periodic_create_pod``'s retry-or-give-up flow) so a stockout does
    not wedge the master control loop.  ``node_failed_hook(node_id, why)``
    lets the master count an exhausted creation against the node's
    relaunch budget.  Instance naming is ``{job_name}-worker-{node_id}``
    and every VM carries the master address in metadata so the agent on
    the VM can join the rendezvous on boot.
    """

    CREATE_RETRIES = 3
    RETRY_BACKOFF_S = 2.0
    # How long after a create lands before a dead list() reading for the
    # node is believed: real-cloud list caches can keep serving the
    # pre-delete record of the instance a relaunch just replaced for well
    # over the master's 2-tick reconcile debounce.
    LANDED_SETTLE_S = 60.0

    def __init__(
        self,
        client: TpuVmClient,
        job_name: str,
        master_addr: str = "",
        accelerator_type: str = "v5litepod-8",
        runtime_version: str = "tpu-ubuntu2204-base",
        node_failed_hook: Optional[Callable[[int, str], None]] = None,
    ):
        self.client = client
        self.job_name = job_name
        self.master_addr = master_addr
        self.accelerator_type = accelerator_type
        self.runtime_version = runtime_version
        self.node_failed_hook = node_failed_hook
        self._queue: "queue.Queue[int]" = queue.Queue()
        # Nodes the job currently wants alive: delete() retracts a node so
        # a still-queued create for it is dropped instead of leaking an
        # orphan VM (retire racing the creator thread).
        self._wanted: set = set()
        self._wanted_mu = threading.Lock()
        # Launch generations: each launch() bumps the node's generation;
        # the creator thread marks the generation landed once its create
        # call (or an already-live VM) is confirmed.  A dead VM seen by
        # reconcile() is only the CURRENT one when the landed generation
        # matches — otherwise it is the stale instance a relaunch is in
        # the middle of replacing.
        self._generation: Dict[int, int] = {}
        self._landed_gen: Dict[int, int] = {}
        self._landed_at: Dict[int, float] = {}
        self._stop = threading.Event()
        self._creator = threading.Thread(
            target=self._create_loop, name="tpu-vm-creator", daemon=True
        )
        self._creator.start()

    # -- naming ------------------------------------------------------------

    def instance_name(self, node_id: int) -> str:
        return f"{self.job_name}-worker-{node_id}"

    def node_id_of(self, name: str) -> Optional[int]:
        prefix = f"{self.job_name}-worker-"
        if not name.startswith(prefix):
            return None
        try:
            return int(name[len(prefix):])
        except ValueError:
            return None

    # -- NodeLauncher ------------------------------------------------------

    def launch(self, node_id: int) -> None:
        with self._wanted_mu:
            self._wanted.add(node_id)
            self._generation[node_id] = self._generation.get(node_id, 0) + 1
        self._queue.put(node_id)

    def _mark_landed(self, node_id: int, gen: int):
        # ``gen`` is the generation snapshot taken when the creator picked
        # the node up — recording the generation current at COMPLETION time
        # would mark an in-flight newer launch landed before its create
        # ever ran.
        with self._wanted_mu:
            self._landed_gen[node_id] = gen
            self._landed_at[node_id] = time.monotonic()

    def vm_is_current(self, node_id: int) -> bool:
        """True when the VM visible in the cloud belongs to the newest
        launch() of this node (its create landed, no newer launch is
        pending, and the landing has had ``LANDED_SETTLE_S`` to propagate
        through the cloud's list() cache) — the reconcile disambiguator
        for PENDING nodes."""
        with self._wanted_mu:
            gen = self._generation.get(node_id, 0)
            if gen <= 0 or self._landed_gen.get(node_id) != gen:
                return False
            settled = time.monotonic() - self._landed_at.get(node_id, 0.0)
            return settled > self.LANDED_SETTLE_S

    def delete(self, node_id: int) -> None:
        with self._wanted_mu:
            self._wanted.discard(node_id)
        name = self.instance_name(node_id)
        try:
            self.client.delete_node(name)
            logger.info("cloud launcher: deleted %s", name)
        except CloudError as e:
            logger.warning("cloud launcher: delete %s failed: %s", name, e)

    def shutdown(self):
        self._stop.set()
        self._creator.join(timeout=5)

    # -- creation ----------------------------------------------------------

    def _create_loop(self):
        """ref ``pod_scaler.py:414`` ``_periodic_create_pod``."""
        while not self._stop.is_set():
            try:
                node_id = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._wanted_mu:
                if node_id not in self._wanted:
                    # Retired while queued: creating now would orphan a VM.
                    logger.info(
                        "cloud launcher: dropping queued create for "
                        "retired node %d", node_id,
                    )
                    continue
            # The creator thread must survive ANYTHING: an escaped
            # exception here would silently kill the daemon and wedge
            # every future launch on an undrained queue.
            try:
                self._create_with_retry(node_id)
            except CloudError as e:
                # Transient API failure outside the per-call handling
                # (e.g. a get_node blip): re-enqueue after backoff.
                logger.warning(
                    "cloud launcher: transient API failure for node %d "
                    "(%s); requeueing", node_id, e,
                )
                if not self._stop.wait(self.RETRY_BACKOFF_S):
                    self._queue.put(node_id)
            except Exception as e:  # noqa: BLE001
                logger.error(
                    "cloud launcher: unexpected error creating node %d: "
                    "%s", node_id, e,
                )
                if self.node_failed_hook is not None:
                    self.node_failed_hook(node_id, str(e))

    def _create_with_retry(self, node_id: int):
        """One launch request, driven to completion by the shared
        RetryPolicy: bounded jittered attempts, abortable backoff (the
        stop event's ``wait`` is the sleep, so shutdown never blocks on a
        backoff window), and an abort check so a node retired mid-backoff
        is abandoned instead of leaking an untracked, billing VM.
        """
        name = self.instance_name(node_id)
        with self._wanted_mu:
            gen = self._generation.get(node_id, 0)

        def abandoned() -> bool:
            if self._stop.is_set():
                return True
            with self._wanted_mu:
                return node_id not in self._wanted

        def attempt():
            existing = self.client.get_node(name)
            if existing is not None and existing["state"] in (
                TpuVmState.CREATING, TpuVmState.READY
            ):
                # Includes the partial-failure case: a create that errored
                # client-side but landed server-side IS a success — never
                # report a healthy VM as failed.
                logger.info("cloud launcher: %s already %s", name,
                            existing["state"])
                return
            if existing is not None:
                # A dead VM (PREEMPTED/TERMINATED) holds the name on some
                # surfaces: clear it first.
                try:
                    self.client.delete_node(name)
                except CloudError:
                    pass
            self.client.create_node(
                name,
                accelerator_type=self.accelerator_type,
                runtime_version=self.runtime_version,
                metadata={
                    "dlrover-master-addr": self.master_addr,
                    "dlrover-node-id": str(node_id),
                    "dlrover-job": self.job_name,
                },
            )
            logger.info("cloud launcher: creating %s (%s)", name,
                        self.accelerator_type)

        policy = RetryPolicy(
            max_attempts=self.CREATE_RETRIES,
            base_delay_s=self.RETRY_BACKOFF_S,
            max_delay_s=max(self.RETRY_BACKOFF_S * 4, 10.0),
            retryable=(CloudError,),
            sleep=self._stop.wait,
            abort=abandoned,
            name=f"create:{name}",
        )
        try:
            policy.call(attempt)
            self._mark_landed(node_id, gen)
            return
        except RetryAborted:
            logger.info(
                "cloud launcher: abandoning create of retired node %d",
                node_id,
            )
            return
        except RetryError as e:
            last_err = e.last_error
        # One final state check: the last attempt may have landed.
        existing = self.client.get_node(name)
        if existing is not None and existing["state"] in (
            TpuVmState.CREATING, TpuVmState.READY
        ):
            self._mark_landed(node_id, gen)
            return
        logger.error("cloud launcher: giving up on %s (%s)", name, last_err)
        if self.node_failed_hook is not None:
            self.node_failed_hook(node_id, str(last_err))

    # -- watcher role ------------------------------------------------------

    def reconcile(self) -> Dict[int, str]:
        """Poll cloud state -> {node_id: TpuVmState}; the master maps
        PREEMPTED/TERMINATED onto node-death handling (the reference's pod
        watcher role, as a poll)."""
        states: Dict[int, str] = {}
        for inst in self.client.list_nodes():
            node_id = self.node_id_of(inst["name"])
            if node_id is not None:
                states[node_id] = inst["state"]
        return states
