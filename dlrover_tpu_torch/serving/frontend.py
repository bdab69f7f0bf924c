"""Front door for the serving fleet: admission, deadlines, shedding (port
of ``dlrover_tpu/serving/frontend.py``).

The transport-facing half of the serving survivability layer.  It speaks
the typed messages of ``master/messages.py`` and is transport-agnostic:
callers drive it directly, or through the master's servicer
(``JobMaster.attach_serve_frontend``: ``ServeSubmit``/``ServeCancel``
ride ``report`` and ``ServePoll`` rides ``get``, as in the reference).

Admission control is *fail fast or not at all*:

* **bounded queue** — more than ``max_pending`` requests in the system
  rejects with ``queue_full`` before anything is allocated; an unbounded
  deque under overload is how queue collapse starts.
* **load shedding** — predicted wait (fleet queue depth ÷ measured
  service rate from the replicas' ``stats()``) over the request's own
  ``deadline_s`` rejects with ``shed`` *now*, in submit, for the cost of
  two dict sums — an early cheap "no" instead of a deadline timeout the
  client pays for in full.  With no measured rate yet (cold fleet) no
  shed verdict is possible and the request is admitted.
* the ``serve.rpc`` Faultline seam fires on every submit/poll/cancel, so
  chaos plans cover the front door itself (a fired error fails that one
  RPC; the caller's RetryPolicy re-issues it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master import messages as msg
from dlrover_tpu_torch.rl.generation import SamplingParams
from dlrover_tpu_torch.serving.engine import Request
from dlrover_tpu_torch.serving.fleet import NoReplicaError, ReplicaFleet


#: The deadline of a request that sets none (``ServeSubmit.deadline_s``
#: 0), against which its predicted wait is judged.
DEFAULT_DEADLINE_S = 30.0


class ServeFrontend:
    """submit/poll/cancel over a :class:`ReplicaFleet`."""

    def __init__(self, fleet: ReplicaFleet, *, max_pending: int = 64):
        self.fleet = fleet
        self.max_pending = max_pending
        # uid -> terminal verdicts the fleet does not track itself.
        self._shed: Dict[str, str] = {}
        self.submitted = 0
        self.shed_count = 0
        self.rejected_full = 0

    # -- admission ------------------------------------------------------------

    def predicted_wait_s(self) -> float:
        """Queue depth ÷ measured service rate; 0 while the fleet has no
        measured rate (cold start — no evidence to shed on)."""
        rate = self.fleet.service_rate()
        if rate <= 0.0:
            return 0.0
        return self.fleet.queue_depth() / rate

    def submit(self, p: msg.ServeSubmit) -> msg.ServeTicket:
        faults.fire("serve.rpc", op="submit", uid=p.uid)
        deadline = (
            p.deadline_s if p.deadline_s > 0 else DEFAULT_DEADLINE_S
        )
        if self.fleet.pending() >= self.max_pending:
            self.rejected_full += 1
            self._shed[p.uid] = "queue_full"
            return msg.ServeTicket(
                uid=p.uid, accepted=False, reason="queue_full",
                predicted_wait_s=self.predicted_wait_s(),
            )
        predicted = self.predicted_wait_s()
        if predicted > deadline:
            self.shed_count += 1
            self._shed[p.uid] = "shed"
            return msg.ServeTicket(
                uid=p.uid, accepted=False, reason="shed",
                predicted_wait_s=predicted,
            )
        request = Request(
            uid=p.uid,
            prompt=np.asarray(p.prompt, np.int64),
            sampling=SamplingParams(
                max_new_tokens=p.max_new_tokens,
                temperature=p.temperature,
                top_k=p.top_k,
            ),
            eos_id=p.eos_id,
        )
        try:
            self.fleet.submit(request)
        except NoReplicaError:
            self._shed[p.uid] = "no_fleet"
            return msg.ServeTicket(
                uid=p.uid, accepted=False, reason="no_fleet",
            )
        except ValueError as e:
            logger.warning("serve submit %s rejected: %s", p.uid, e)
            self._shed[p.uid] = "invalid"
            return msg.ServeTicket(
                uid=p.uid, accepted=False, reason=f"invalid: {e}",
            )
        self.submitted += 1
        return msg.ServeTicket(
            uid=p.uid, accepted=True, predicted_wait_s=predicted,
        )

    # -- poll / cancel --------------------------------------------------------

    def _status(self, uid: str) -> msg.ServeStatus:
        result = self.fleet.results.get(uid)
        if result is not None:
            return msg.ServeStatus(
                uid=uid, state="done",
                tokens=tuple(int(t) for t in result.tokens),
                latency_s=result.latency_s,
            )
        if uid in self.fleet.cancelled:
            return msg.ServeStatus(uid=uid, state="cancelled")
        if uid in self._shed:
            return msg.ServeStatus(uid=uid, state=self._shed[uid])
        if uid in self.fleet._assigned:
            return msg.ServeStatus(uid=uid, state="pending")
        return msg.ServeStatus(uid=uid, state="unknown")

    def poll(self, p: msg.ServePoll) -> msg.ServeStatus:
        faults.fire("serve.rpc", op="poll", uid=p.uid)
        return self._status(p.uid)

    def cancel(self, p: msg.ServeCancel) -> msg.ServeStatus:
        faults.fire("serve.rpc", op="cancel", uid=p.uid)
        if self.fleet.cancel(p.uid):
            return msg.ServeStatus(uid=p.uid, state="cancelled")
        return self._status(p.uid)
