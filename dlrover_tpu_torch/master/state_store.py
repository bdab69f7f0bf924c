"""Master state persistence: survive a master restart without losing the
job (port of ``dlrover_tpu/master/state_store.py``).

Capability ref: ``dlrover/python/util/state/store_mananger.py`` (master
state backends; the reference also reconstructs from the k8s watcher, which
has no counterpart here) and SURVEY §1 "master restart recoverable".

The recoverable state is deliberately small — the control plane is mostly
soft state the agents re-establish (heartbeats, rendezvous re-join on
``world_changed``), so what must survive is: dataset shard progress (losing
it re-trains data), node relaunch budgets (losing them resets failure
containment), the rendezvous round counter (so restarted agents' rounds
stay monotonic), and the kv store (coordinator handshakes).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger


class MasterStateStore:
    def __init__(self, path: str):
        self.path = path

    # -- capture --------------------------------------------------------------

    def capture(self, master) -> dict:
        # Every component is read through a lock-taking surface: RPC threads
        # mutate these structures while the control loop persists them.
        rdzv = {}
        for name, manager in master.rdzv_managers.items():
            with manager._lock:
                rdzv[name] = {
                    "round": manager._rdzv_round,
                    "alive": sorted(manager._alive_nodes),
                }
        datasets = {}
        with master.task_manager._lock:
            for name, dm in master.task_manager._datasets.items():
                datasets[name] = {
                    "state": dm.checkpoint(),
                    "params": {
                        "dataset_name": dm.splitter.params.dataset_name,
                        "dataset_size": dm.splitter.params.dataset_size,
                        "shard_size": dm.splitter.params.shard_size,
                        "num_epochs": dm.splitter.params.num_epochs,
                        "shuffle": dm.splitter.params.shuffle,
                        "storage_type": dm.splitter.params.storage_type,
                    },
                }
        nodes = {
            str(node_id): saved
            for node_id, saved in master.node_manager.snapshot().items()
        }
        kv = {
            key: value.hex() if isinstance(value, bytes) else value
            for key, value in master.kv_store.snapshot().items()
        }
        return {
            "saved_at": time.time(),
            "global_step": master.speed_monitor.global_step,
            "rdzv": rdzv,
            "datasets": datasets,
            "nodes": nodes,
            "kv": kv,
            # Monitoring counters a scraper rates over time: losing them to
            # a master restart reads as a mid-incident counter reset on the
            # dlrover_serve_* / dlrover_resize_seconds_total{kind=...}
            # gauges, so they ride the same snapshot.
            "serve": master.speed_monitor.serve_state(),
            "resize": master.speed_monitor.resize_state(),
            "embed": master.speed_monitor.embed_state(),
            # Calibration ratios are learned from profiler capture windows
            # at a slow cadence — relearning them after a master restart
            # would leave the tuner uncorrected for hours.
            "calibration": master.calibration.state(),
            # Classified HBM snapshots: a restarted master must keep the
            # fleet's memory truth (healthz floor, HBM gauges, pressure
            # operator) instead of flying blind until the next report.
            "memory": master.memory_ledger.state(),
        }

    def save(self, master):
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        faults.fire("storage.write", path=os.path.basename(self.path))
        with open(tmp, "w") as f:
            json.dump(self.capture(master), f)
        os.replace(tmp, self.path)

    # -- restore --------------------------------------------------------------

    def load(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        try:
            # The seam sits inside the try: an injected storage.read error
            # takes the same unreadable-state -> start-fresh path a torn or
            # lost state file would, so that path is drillable.
            faults.fire("storage.read", path=os.path.basename(self.path))
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError, faults.FaultInjected) as e:
            logger.error("master state unreadable (%s); starting fresh", e)
            return None

    def restore(self, master) -> bool:
        state = self.load()
        if state is None:
            return False
        from dlrover_tpu_torch.master import messages as msg

        for name, saved in state.get("rdzv", {}).items():
            manager = master.rdzv_managers.get(name)
            if manager is None:
                continue
            with manager._lock:
                # Rounds stay monotonic across the restart; the world itself
                # is NOT restored — agents re-join and seal a fresh round.
                manager._rdzv_round = max(
                    manager._rdzv_round, saved.get("round", 0)
                )
        for name, saved in state.get("datasets", {}).items():
            master.task_manager.create_dataset(
                msg.DatasetShardParams(**saved["params"])
            )
            master.task_manager.restore(
                msg.ShardCheckpoint(name, json.dumps(saved["state"]))
            )
        for node_id, saved in state.get("nodes", {}).items():
            node = master.node_manager.ensure_node(int(node_id))
            node.relaunch_count = saved.get("relaunch_count", 0)
            if saved.get("quarantined"):
                # A quarantined (silently-corrupting) host must stay out
                # after a master restart: re-blacklist it and re-ban its
                # rendezvous rank so a re-join attempt cannot re-admit it.
                master.node_manager.quarantine(
                    int(node_id),
                    saved.get("quarantine_reason", "restored quarantine"),
                )
                for manager in master.rdzv_managers.values():
                    manager.ban_node(int(node_id))
        for key, value in state.get("kv", {}).items():
            try:
                master.kv_store.put(key, bytes.fromhex(value))
            except ValueError:
                continue
        if state.get("serve"):
            master.speed_monitor.restore_serve_state(state["serve"])
        if state.get("resize"):
            master.speed_monitor.restore_resize_state(state["resize"])
        if state.get("embed"):
            master.speed_monitor.restore_embed_state(state["embed"])
        if state.get("calibration"):
            master.calibration.restore(state["calibration"])
        if state.get("memory"):
            master.memory_ledger.restore(state["memory"])
        if state.get("global_step"):
            master.speed_monitor.collect_global_step(
                state["global_step"], timestamp=time.time()
            )
            master.speed_monitor.reset_running_speed()
        logger.info(
            "master state restored from %s (saved %.0fs ago, step %d)",
            self.path, time.time() - state.get("saved_at", 0),
            state.get("global_step", 0),
        )
        return True
