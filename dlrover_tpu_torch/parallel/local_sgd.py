"""Local SGD: low-communication data parallelism (port of
``dlrover_tpu/parallel/local_sgd.py``).

Each replica trains its own world-1 step (``train_lib.build_train`` on
``runtime/mesh.single_device_mesh()``, also where the default group
spans more processes: no data axis, no per-step gradient sum) for
``sync_every`` steps; then the processes gather their parameter deltas
(the parameters less the anchor of the round) and reduce them, by plain
average or GTA sign consensus, and an outer step applies the reduction
to the anchor, with outer momentum when ``outer_momentum`` is set (the
DiLoCo / post-local-SGD family).  Nothing in the model or the step
changes: this wraps any world-1 train step.

The default transport is the world's :class:`~dlrover_tpu_torch.
parallel.wire.Wire`: ``quantized_collectives.process_allgather`` (the
deltas in their dtype), or with ``quantized_comm``
``quantized_collectives.quantized_process_allgather`` (int8 codes and
one fp32 scale a 256-value block: K5a and K5b on the card).  Trees are
``{name: tensor}`` dicts; the anchor and the velocity are this object's
own tensors, and a sync returns new ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel import quantized_collectives as qc

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class LocalSGDConfig:
    sync_every: int = 16          # local steps between outer reductions
    outer_lr: float = 1.0
    outer_momentum: float = 0.9   # 0 = plain averaged delta
    method: str = "average"       # "average" | "gta"
    gta_threshold: float = 0.0    # min |consensus| fraction to keep a coord
    quantized_comm: bool = False  # int8 delta transport


def gta_reduce(deltas: List[Tree], threshold: float = 0.0) -> Tree:
    """Sign-consensus (GTA-style) reduction of the replicas' delta trees:
    per coordinate the majority sign across replicas, the minority-sign
    contributions zeroed, the survivors averaged; a coordinate whose
    consensus is weak (``|mean sign| <= threshold``) is dropped."""

    def reduce_leaf(*leaves):
        stack = torch.stack(leaves)
        signs = torch.sign(stack)
        consensus = torch.sign(signs.sum(dim=0))
        agree = (signs == consensus) & (consensus != 0)
        kept = torch.where(agree, stack, torch.zeros_like(stack))
        count = torch.clamp(agree.sum(dim=0), min=1)
        mean_kept = kept.sum(dim=0) / count
        strength = torch.abs(signs.mean(dim=0))
        return torch.where(strength > threshold, mean_kept,
                           torch.zeros_like(mean_kept))

    return {k: reduce_leaf(*(d[k] for d in deltas)) for k in deltas[0]}


def average_reduce(deltas: List[Tree]) -> Tree:
    """The replicas' mean, summed in replica order (``sum(ls) / len``)."""
    return {k: sum(d[k] for d in deltas) / len(deltas) for k in deltas[0]}


class LocalSGD:
    """The outer loop's state, around a world-1 train step.

    ``allgather_fn(local_delta) -> [delta of each process]`` defaults to
    the world's wire (int8 under ``quantized_comm``); tests inject a
    fabric."""

    def __init__(self, config: LocalSGDConfig,
                 allgather_fn: Optional[Callable[[Tree], List[Tree]]] = None):
        self.config = config
        if allgather_fn is None:
            allgather_fn = (qc.quantized_process_allgather
                            if config.quantized_comm
                            else qc.process_allgather)
        self.allgather_fn = allgather_fn
        self._anchor: Optional[Tree] = None    # outer params of the round
        self._velocity: Optional[Tree] = None  # outer momentum buffer
        self._local_steps = 0

    @staticmethod
    def _own(tree: Tree) -> Tree:
        return {k: v.detach().clone() for k, v in tree.items()}

    def init(self, params: Tree) -> None:
        """Anchor the outer params before the first local step (otherwise
        the first round's first step folds into the anchor)."""
        self._anchor = self._own(params)

    def maybe_sync(self, params: Tree) -> Tuple[Tree, bool]:
        """Call after every local step with the current params: ``(params,
        False)`` between syncs, ``(new params, True)`` at a sync (new
        tensors; copy them into the model)."""
        if self._anchor is None:
            self._anchor = self._own(params)
        self._local_steps += 1
        if self._local_steps < self.config.sync_every:
            return params, False
        self._local_steps = 0
        with torch.no_grad():
            delta = {k: p.detach() - self._anchor[k]
                     for k, p in params.items()}
            deltas = self.allgather_fn(delta)
            if self.config.method == "gta":
                reduced = gta_reduce(deltas, self.config.gta_threshold)
            else:
                reduced = average_reduce(deltas)
            if self.config.outer_momentum:
                if self._velocity is None:
                    self._velocity = {k: torch.zeros_like(d)
                                      for k, d in reduced.items()}
                self._velocity = {
                    k: self.config.outer_momentum * self._velocity[k] + d
                    for k, d in reduced.items()}
                applied = self._velocity
            else:
                applied = reduced
            new_params = {k: a + self.config.outer_lr * applied[k]
                          for k, a in self._anchor.items()}
        self._anchor = self._own(new_params)
        logger.info(
            "local-sgd outer sync applied (%s over %d replicas)",
            self.config.method, len(deltas),
        )
        return new_params, True

    def state_dict(self) -> Dict:
        return {
            "local_steps": self._local_steps,
            "anchor": self._anchor,
            "velocity": self._velocity,
        }

    def load_state_dict(self, state: Dict) -> None:
        self._local_steps = state.get("local_steps", 0)
        self._anchor = state.get("anchor")
        self._velocity = state.get("velocity")
