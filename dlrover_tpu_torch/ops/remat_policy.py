"""Named remat (activation checkpointing) policies (port of
``dlrover_tpu/ops/remat_policy.py``).

The names are the JAX registry's, so a config's ``remat`` string means the
same in both packages; :func:`validate` resolves it as the JAX one does
(unknown names and flash-name policies under a non-flash attention impl
raise ``ValueError``).  Ported so far:

* ``none``: no checkpointing; every activation is kept.
* ``full``: each block runs under ``torch.utils.checkpoint`` and the
  backward re-runs the whole block forward, the flash kernel included.
* ``flash_only``: the same, but the flash forward's outputs ``(o, lse)``
  are kept from the block's first run and handed back in its recompute
  (``flash_attention.KeptOutputs``), so the backward re-runs everything
  in the block except the attention forward: the selective policy that
  would mark the ``dlrover_tpu_torch::flash_fwd`` op ``MUST_SAVE``,
  without selective checkpointing's dispatch mode, whose Python hook on
  every op of the forward and of the recompute costs host time (on an
  H100 host it left the step after a metrics flush host-bound).  The flash forward then runs
  once per layer per step, against twice under ``full``; everything else
  in the block, an MoE layer's grouped-matmul op included, runs twice.

Every other registered name (``dots``, ``dots_no_batch``, ``attn_out``,
``branch_out``, ``flash_res``, ``offload``, ``offload:<names>``) raises
``NotImplementedError``: they are a later part of the training slice.
The accounting metadata the JAX registry carries for ``auto/tune.py`` is
not ported with them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.ops import flash_attention

OFFLOADABLE_NAMES: Tuple[str, ...] = (
    "qkv_proj", "attn_out", "mlp_out", "mlp_wo", "flash_out", "flash_lse",
)
DEFAULT_OFFLOAD_NAMES: Tuple[str, ...] = ("qkv_proj", "attn_out", "mlp_wo")
_FLASH_NAMES = frozenset(("flash_out", "flash_lse"))
PORTED = ("none", "full", "flash_only")


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """One named policy: what it keeps resident and what it offloads."""

    name: str
    saved_names: Tuple[str, ...] = ()
    offload_names: Tuple[str, ...] = ()

    @property
    def requires_flash(self) -> bool:
        return any(
            n in _FLASH_NAMES for n in self.saved_names + self.offload_names
        )


_REGISTRY = {p.name: p for p in (
    RematPolicy("none"),
    RematPolicy("full"),
    RematPolicy("dots"),
    RematPolicy("dots_no_batch"),
    RematPolicy("attn_out", saved_names=("attn_out",)),
    RematPolicy("branch_out", saved_names=("attn_out", "mlp_out")),
    RematPolicy("flash_res",
                saved_names=("attn_out", "flash_out", "flash_lse")),
    RematPolicy("flash_only", saved_names=("flash_out", "flash_lse")),
    RematPolicy("offload", offload_names=DEFAULT_OFFLOAD_NAMES),
)}


def resolve(name: str) -> RematPolicy:
    """Policy object for a remat string; raises ValueError when unknown."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("offload:"):
        names = [n.strip() for n in name[len("offload:"):].split(",")
                 if n.strip()]
        unknown = sorted(set(names) - set(OFFLOADABLE_NAMES))
        if unknown or not names:
            raise ValueError(
                f"offload:<names> takes names from {list(OFFLOADABLE_NAMES)}"
                f", got {names}"
            )
        return RematPolicy(
            name, offload_names=tuple(n for n in OFFLOADABLE_NAMES
                                      if n in names))
    raise ValueError(
        f"remat must be one of {sorted(_REGISTRY)} or 'offload:<names>' "
        f"with names from {list(OFFLOADABLE_NAMES)}, got {name!r}"
    )


def validate(name: str, attention_impl: str = "xla") -> RematPolicy:
    """Resolve and check impl compatibility, as the JAX registry does, then
    refuse the policies this port does not run yet."""
    policy = resolve(name)
    if policy.requires_flash and attention_impl != "flash":
        raise ValueError(
            f"remat={policy.name!r} requires attention_impl='flash', got "
            f"{attention_impl!r}"
        )
    if policy.name not in PORTED:
        raise NotImplementedError(
            f"remat={policy.name!r} is a later slice of the port (training: "
            f"the policies other than {list(PORTED)} and host offload, "
            f"ROADMAP Queue 1 item 7)"
        )
    return policy


def run(name: str, fn: Callable, *args):
    """``fn(*args)`` under the policy ``name`` (see the module docstring).
    Outside autograd (``torch.no_grad``) nothing is checkpointed."""
    if name == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if name == "flash_only":
        store = flash_attention.KeptOutputs()

        def body(*a):
            with flash_attention.kept_outputs(store):
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False)
    if name != "full":
        validate(name)  # raises: not a ported policy
    return checkpoint(fn, *args, use_reentrant=False)
