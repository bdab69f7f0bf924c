"""Production Cloud TPU API client (``tpu.googleapis.com`` v2; port of
``dlrover_tpu/master/tpu_api.py``).

Capability ref: ``dlrover/python/scheduler/kubernetes.py:1-572`` — the
reference ships a working cluster client (k8s api wrapper with auth,
retries, typed create/delete/get/list) under its pod scaler; this is the
TPU-VM equivalent under :class:`CloudNodeLauncher`
(``master/cloud_launcher.py``).

Design notes:

* **stdlib HTTP only** (urllib): the control plane must not grow a
  google-cloud SDK dependency for four REST verbs.  The API surface used
  is ``projects.locations.nodes`` create/delete/get/list, exactly what
  the launcher seam needs.
* **Auth via the GCE metadata server** — the master runs on a TPU VM or
  GCE instance in production, where
  ``metadata.google.internal/.../token`` mints OAuth2 access tokens with
  no key material on disk.  Tokens are cached until ~60 s before expiry.
  Tests (and non-GCE deployments) inject ``token_fn`` or point
  ``metadata_host`` / ``base_url`` at fakes.
* **Long-running operations are NOT awaited**: create/delete return
  operations, but the launcher's contract is eventually-consistent
  polling (``get_node``/``list_nodes`` + ``reconcile``), so the client
  fires the mutation and lets the poll observe the outcome — the same
  shape as the reference's pod watcher.
* Errors map onto :class:`CloudError` with the API's status string
  (``RESOURCE_EXHAUSTED``, ``ALREADY_EXISTS``, ``NOT_FOUND``...) so the
  launcher's retry/give-up logic is client-agnostic.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.cloud_launcher import CloudError, TpuVmClient, TpuVmState

_METADATA_TOKEN_PATH = (
    "/computeMetadata/v1/instance/service-accounts/default/token"
)
_METADATA_ATTR_PATH = "/computeMetadata/v1/instance/attributes/"

# Cloud TPU node states -> the launcher's coarse lifecycle.  Transient
# repair states count as CREATING (alive, not yet usable): reconcile must
# not declare a REPAIRING node dead, and the launcher's "already exists"
# check must not try to re-create over it.
_STATE_MAP = {
    "CREATING": TpuVmState.CREATING,
    "STARTING": TpuVmState.CREATING,
    "RESTARTING": TpuVmState.CREATING,
    "REIMAGING": TpuVmState.CREATING,
    "REPAIRING": TpuVmState.CREATING,
    "READY": TpuVmState.READY,
    "STOPPING": TpuVmState.TERMINATED,
    "STOPPED": TpuVmState.TERMINATED,
    "DELETING": TpuVmState.TERMINATED,
    "TERMINATED": TpuVmState.TERMINATED,
    "PREEMPTED": TpuVmState.PREEMPTED,
}


def map_node_state(api_state: str) -> str:
    return _STATE_MAP.get(api_state, TpuVmState.CREATING)


def make_cloud_launcher(
    job_name: str,
    master_addr: str,
    accelerator_type: str = "v5litepod-8",
    runtime_version: str = "tpu-ubuntu2204-base",
    preemptible: bool = False,
    project: str = "",
    zone: str = "",
):
    """Production wiring: HTTP client + CloudNodeLauncher in one call
    (the ``run.py --master-only --cloud`` actuation path)."""
    from dlrover_tpu_torch.master.cloud_launcher import CloudNodeLauncher

    client = TpuVmHttpClient(
        project=project, zone=zone, preemptible=preemptible
    )
    return CloudNodeLauncher(
        client, job_name=job_name, master_addr=master_addr,
        accelerator_type=accelerator_type,
        runtime_version=runtime_version,
    )


class TpuVmHttpClient(TpuVmClient):
    """HTTP implementation of the four launcher verbs.

    ``project``/``zone`` resolve from args, then env
    (``GCP_PROJECT``/``TPU_ZONE``), then the metadata server.  ``base_url``
    and ``metadata_host`` exist so integration tests can stand up local
    fakes speaking the real JSON shapes.
    """

    REQUEST_TIMEOUT_S = 30.0

    def __init__(
        self,
        project: str = "",
        zone: str = "",
        base_url: str = "https://tpu.googleapis.com/v2",
        metadata_host: str = "http://metadata.google.internal",
        token_fn: Optional[Callable[[], str]] = None,
        preemptible: bool = False,
    ):
        self.base_url = base_url.rstrip("/")
        self.metadata_host = metadata_host.rstrip("/")
        self.preemptible = preemptible
        self._token_fn = token_fn
        self._token = ""
        self._token_expiry = 0.0
        self.project = (
            project or os.environ.get("GCP_PROJECT", "")
            or self._metadata_attr("project-id", project_level=True)
        )
        self.zone = (
            zone or os.environ.get("TPU_ZONE", "")
            or self._zone_from_metadata()
        )
        if not self.project or not self.zone:
            raise CloudError(
                "INVALID_ARGUMENT: project/zone unresolved (set "
                "GCP_PROJECT/TPU_ZONE or run on GCE)"
            )

    # -- auth / metadata ---------------------------------------------------

    def _metadata_get(self, path: str) -> str:
        faults.fire("tpu.api", path=path)
        req = urllib.request.Request(
            self.metadata_host + path,
            headers={"Metadata-Flavor": "Google"},
        )
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            return resp.read().decode()

    def _metadata_attr(self, name: str, project_level: bool = False) -> str:
        prefix = (
            "/computeMetadata/v1/project/" if project_level
            else _METADATA_ATTR_PATH
        )
        try:
            return self._metadata_get(prefix + name)
        except (urllib.error.URLError, OSError, faults.FaultInjected):
            return ""

    def _zone_from_metadata(self) -> str:
        try:
            # "projects/<num>/zones/<zone>"
            full = self._metadata_get("/computeMetadata/v1/instance/zone")
            return full.rsplit("/", 1)[-1]
        except (urllib.error.URLError, OSError, faults.FaultInjected):
            return ""

    def _access_token(self) -> str:
        if self._token_fn is not None:
            return self._token_fn()
        now = time.monotonic()
        if self._token and now < self._token_expiry - 60.0:
            return self._token
        payload = json.loads(self._metadata_get(_METADATA_TOKEN_PATH))
        self._token = payload["access_token"]
        self._token_expiry = now + float(payload.get("expires_in", 300))
        return self._token

    # -- REST plumbing -----------------------------------------------------

    @property
    def _parent(self) -> str:
        return f"projects/{self.project}/locations/{self.zone}"

    def _request(
        self, method: str, path: str, body: Optional[Dict] = None,
        query: Optional[Dict[str, str]] = None,
    ) -> Dict:
        url = f"{self.base_url}/{path}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        try:
            token = self._access_token()
        except (urllib.error.URLError, OSError, KeyError, ValueError,
                faults.FaultInjected) as e:
            # The TpuVmClient contract is CloudError on ANY API failure —
            # a raw metadata-server exception would kill the launcher's
            # creator thread instead of being retried.
            raise CloudError(
                f"UNAUTHENTICATED: token fetch failed: {e}"
            ) from e
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={
                "Authorization": f"Bearer {token}",
                "Content-Type": "application/json",
            },
        )
        try:
            faults.fire("tpu.api", path=path)
            with urllib.request.urlopen(
                req, timeout=self.REQUEST_TIMEOUT_S
            ) as resp:
                raw = resp.read()
                return json.loads(raw) if raw else {}
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            status = str(e.code)
            try:
                status = json.loads(detail)["error"].get("status", status)
            except (ValueError, KeyError, TypeError):
                pass
            raise CloudError(
                f"{status}: {method} {path}: {detail[:500]}"
            ) from e
        except (urllib.error.URLError, OSError, TimeoutError,
                faults.FaultInjected) as e:
            raise CloudError(f"UNAVAILABLE: {method} {path}: {e}") from e

    # -- TpuVmClient -------------------------------------------------------

    def create_node(self, name: str, accelerator_type: str,
                    runtime_version: str, metadata: Dict[str, str]) -> None:
        body = {
            "acceleratorType": accelerator_type,
            "runtimeVersion": runtime_version,
            "metadata": dict(metadata),
        }
        if self.preemptible:
            body["schedulingConfig"] = {"preemptible": True}
        self._request(
            "POST", f"{self._parent}/nodes", body=body,
            query={"nodeId": name},
        )
        logger.info("tpu api: create %s (%s) submitted", name,
                    accelerator_type)

    def delete_node(self, name: str) -> None:
        self._request("DELETE", f"{self._parent}/nodes/{name}")
        logger.info("tpu api: delete %s submitted", name)

    def get_node(self, name: str) -> Optional[Dict]:
        try:
            node = self._request("GET", f"{self._parent}/nodes/{name}")
        except CloudError as e:
            if str(e).startswith(("NOT_FOUND", "404")):
                return None
            raise
        return self._to_launcher_view(node)

    def list_nodes(self) -> List[Dict]:
        nodes: List[Dict] = []
        page_token = ""
        while True:
            query = {"pageToken": page_token} if page_token else None
            payload = self._request(
                "GET", f"{self._parent}/nodes", query=query
            )
            nodes.extend(
                self._to_launcher_view(n) for n in payload.get("nodes", [])
            )
            page_token = payload.get("nextPageToken", "")
            if not page_token:
                # No TERMINATED filtering here (unlike the fake, whose
                # TERMINATED means "deleted"): the real API drops deleted
                # nodes from list() itself, while STOPPED/STOPPING nodes
                # — which map to TERMINATED — remain listed and MUST stay
                # visible or reconcile() can never declare them dead.
                return nodes

    def _to_launcher_view(self, node: Dict) -> Dict:
        """API node JSON -> the dict shape the launcher consumes (same
        keys as :class:`FakeTpuVmClient` instances)."""
        return {
            # API names are fully qualified "projects/.../nodes/<id>".
            "name": node.get("name", "").rsplit("/", 1)[-1],
            "accelerator_type": node.get("acceleratorType", ""),
            "runtime_version": node.get("runtimeVersion", ""),
            "metadata": dict(node.get("metadata", {})),
            "state": map_node_state(node.get("state", "")),
            "api_state": node.get("state", ""),
        }
