"""Named remat (activation checkpointing) policies, host offload among
them (port of ``dlrover_tpu/ops/remat_policy.py``).

The registry is the reference's: the same names, the same canonical
``offload:<names>`` spelling (equal sets compare equal, the default set
is ``"offload"``), the same errors, and the same accounting fields
(``hbm_act_per_token_layer``, ``recompute_fraction``,
``offload_bytes_per_token_layer``, :data:`SAVEABLE_BYTES`,
:data:`RECOMPUTE_AVOIDED`), which price a policy for a tuner and for
``chip_smoke.py``'s predictions.

How a policy runs (:func:`run`).  Each block runs under non-reentrant
``torch.utils.checkpoint``: its forward keeps no activation, and its
backward re-runs the block.  A policy keeps a set of **named sites**: a
site's output is kept from the block's first run and handed back in the
recompute, in call order from the start of the block (a recompute that
the checkpoint stops early has read a prefix).  Everything else re-runs.
A site is a product whose backward is known without its output: for
``y = x @ W + b`` the replay saves ``x`` and ``W``, as the product itself
does, so the checkpoint refills the same saved tensors in the same order
(:class:`_Product`; the flash forward's ``(o, lse)`` through
``ops/flash_attention._Replay``).  The sites, with the reference's names:

* ``qkv_proj``: the q/k/v projections (fused or split), after the bias;
* ``attn_out``: the attention's output projection, after the bias (under
  ``pin_attn_layouts`` the pin's copy of it re-runs);
* ``mlp_wo`` and ``mlp_out``: a dense MLP's ``wo`` product (both names
  are that tensor, as in the reference); ``mlp_out`` of an MoE block is
  its combine (the einsum dispatch's last product; the grouped
  dispatch's scatter of the weighted rows);
* ``flash_out`` and ``flash_lse``: the flash forward's outputs (replayed
  when the policy keeps both; the kernel runs again otherwise);
* every product the reference computes as a ``dot_general`` for ``dots``
  (each ``DenseGeneral``, the ``xla`` attention's score and value
  products, an MoE block's einsums), and of those only the ones without
  batch dimensions for ``dots_no_batch`` (the ``DenseGeneral``
  products).  Products inside a kernel (the flash kernels, the grouped
  GEMM) are not dots and re-run.

A name the model never emits keeps nothing: an MoE block has no
``mlp_wo``.  ``offload`` and ``offload:<names>`` keep their sites in host
memory: on the card each kept tensor is copied into **pinned** host
memory on a side stream (the allocator told through ``record_stream``
that the copy reads the block), the device tensor freed with the block's
forward, and the block's copies brought back on the side stream when
its recompute starts, each waited for where it is replayed.  A pinned
allocation that fails raises: nothing falls back to keeping the tensor
on the card.  On the CPU the same code keeps a copy on the CPU.
:data:`COUNTS` says what each step kept and moved.

Outside autograd (``torch.no_grad``) nothing is checkpointed and no site
is kept.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

# bf16 bytes per token-layer of each named saveable, in residual-stream
# (d_model) multiples.  qkv_proj is the fused [B, S, H, 3 hd] projection.
SAVEABLE_BYTES: Dict[str, float] = {
    "qkv_proj": 3.0,
    "attn_out": 1.0,
    "mlp_out": 1.0,
    "mlp_wo": 1.0,
    "flash_out": 1.0,
    "flash_lse": 0.05,
}

# Fraction of the layer's forward matmul FLOPs whose backward recompute a
# saved or offloaded name removes (the reference's estimates).
RECOMPUTE_AVOIDED: Dict[str, float] = {
    "qkv_proj": 0.45,
    "attn_out": 0.30,
    "mlp_out": 0.25,
    "mlp_wo": 0.25,
    "flash_out": 0.25,
    "flash_lse": 0.0,
}

# The canonical name order.
OFFLOADABLE_NAMES: Tuple[str, ...] = tuple(SAVEABLE_BYTES)
DEFAULT_OFFLOAD_NAMES: Tuple[str, ...] = ("qkv_proj", "attn_out", "mlp_wo")
_FLASH_NAMES = frozenset(("flash_out", "flash_lse"))

#: Per step: bytes kept on the device by site name (``kept``), bytes
#: copied to and from host memory (``d2h``, ``h2d``), host copies made
#: and how many of them are pinned (``host``, ``pinned``), and sites
#: replayed by name (``replays``).  A run sets them to 0 and reads them.
COUNTS = {"kept": collections.Counter(), "d2h": 0, "h2d": 0, "host": 0,
          "pinned": 0, "replays": collections.Counter()}


def reset_counts() -> None:
    COUNTS["kept"].clear()
    COUNTS["replays"].clear()
    for key in ("d2h", "h2d", "host", "pinned"):
        COUNTS[key] = 0


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """One named policy: the sites it keeps on the device
    (``saved_names``), those it keeps in host memory (``offload_names``),
    the products it keeps (``builtin``: the reference's
    ``jax.checkpoint_policies`` name, ``checkpoint_dots`` or
    ``checkpoint_dots_with_no_batch_dims``; ``nothing_saveable`` for
    ``full``), and the reference's accounting."""

    name: str
    saved_names: Tuple[str, ...] = ()
    offload_names: Tuple[str, ...] = ()
    builtin: str = ""
    # HBM-resident saved activation bytes per token-layer (bf16
    # residual-stream multiples), offloaded names excluded.
    hbm_act_per_token_layer: float = 1.0
    # Fraction of forward matmul FLOPs re-run in the backward.
    recompute_fraction: float = 1.0

    @property
    def requires_flash(self) -> bool:
        return any(
            n in _FLASH_NAMES for n in self.saved_names + self.offload_names
        )

    @property
    def offload_bytes_per_token_layer(self) -> float:
        return sum(SAVEABLE_BYTES[n] for n in self.offload_names)

    @property
    def dots(self) -> str:
        """The products kept: ``"all"``, ``"no_batch"`` or ``""``."""
        return {"checkpoint_dots": "all",
                "checkpoint_dots_with_no_batch_dims": "no_batch"}.get(
                    self.builtin, "")


_REGISTRY: Dict[str, RematPolicy] = {}


def register(policy: RematPolicy) -> RematPolicy:
    _REGISTRY[policy.name] = policy
    return policy


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _canonical_offload_names(names: Sequence[str]) -> Tuple[str, ...]:
    unknown = sorted(set(names) - set(OFFLOADABLE_NAMES))
    if unknown:
        raise ValueError(
            f"unknown offload target(s) {unknown}; offloadable names are "
            f"{list(OFFLOADABLE_NAMES)}"
        )
    if not names:
        raise ValueError("offload:<names> needs at least one name")
    return tuple(n for n in OFFLOADABLE_NAMES if n in set(names))


def offload_policy_name(names: Sequence[str]) -> str:
    """Canonical policy string for an offload name set."""
    canon = _canonical_offload_names(names)
    if canon == DEFAULT_OFFLOAD_NAMES:
        return "offload"
    return "offload:" + ",".join(canon)


def offload_policy(names: Sequence[str]) -> RematPolicy:
    canon = _canonical_offload_names(names)
    avoided = sum(RECOMPUTE_AVOIDED[n] for n in canon)
    recompute = 0.0 if avoided >= 1.0 - 1e-9 else 1.0 - avoided
    return RematPolicy(
        name=offload_policy_name(canon),
        offload_names=canon,
        hbm_act_per_token_layer=1.0,
        recompute_fraction=recompute,
    )


# ---- registered policies (the reference's accounting constants) -----------
register(RematPolicy(
    "none", hbm_act_per_token_layer=12.0, recompute_fraction=0.0,
))
register(RematPolicy(
    "full", builtin="nothing_saveable",
    hbm_act_per_token_layer=1.0, recompute_fraction=1.0,
))
register(RematPolicy(
    "dots", builtin="checkpoint_dots",
    hbm_act_per_token_layer=8.0, recompute_fraction=0.3,
))
register(RematPolicy(
    "dots_no_batch", builtin="checkpoint_dots_with_no_batch_dims",
    hbm_act_per_token_layer=6.0, recompute_fraction=0.3,
))
register(RematPolicy(
    "attn_out", saved_names=("attn_out",),
    hbm_act_per_token_layer=2.0, recompute_fraction=0.85,
))
register(RematPolicy(
    "branch_out", saved_names=("attn_out", "mlp_out"),
    hbm_act_per_token_layer=3.0, recompute_fraction=0.7,
))
register(RematPolicy(
    "flash_res", saved_names=("attn_out", "flash_out", "flash_lse"),
    hbm_act_per_token_layer=3.05, recompute_fraction=0.55,
))
register(RematPolicy(
    "flash_only", saved_names=("flash_out", "flash_lse"),
    hbm_act_per_token_layer=2.05, recompute_fraction=0.7,
))
register(offload_policy(DEFAULT_OFFLOAD_NAMES))


def resolve(name: Union[str, RematPolicy]) -> RematPolicy:
    """Policy object for a remat string; raises ValueError when unknown."""
    if isinstance(name, RematPolicy):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("offload:"):
        return offload_policy(
            [n.strip() for n in name[len("offload:"):].split(",") if n.strip()]
        )
    raise ValueError(
        f"remat must be one of {list(available())} or 'offload:<names>' "
        f"with names from {list(OFFLOADABLE_NAMES)}, got {name!r}"
    )


def validate(name: str, attention_impl: str = "xla") -> RematPolicy:
    """Resolve and check impl compatibility, as the reference does: the
    flash names exist only inside the flash attention, so elsewhere a
    policy keeping them would keep nothing."""
    policy = resolve(name)
    if policy.requires_flash and attention_impl != "flash":
        raise ValueError(
            f"remat={policy.name!r} requires attention_impl='flash', got "
            f"{attention_impl!r}"
        )
    return policy


# ---- the kept sites -----------------------------------------------------------

#: One side stream a device for the host copies.
_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device=device)
    return _SIDE[device]


class _Kept:
    """One kept tensor: on the device, or as a host copy (offload) with
    the events of its copies."""

    def __init__(self, t: torch.Tensor, name: str, offload: bool):
        self.name = name
        self.nbytes = t.numel() * t.element_size()
        self.device = None
        self.host = None
        self.fetched = None
        self.ready = None
        if not offload:
            self.device = t.detach()
            COUNTS["kept"][name] += self.nbytes
            return
        COUNTS["d2h"] += self.nbytes
        COUNTS["host"] += 1
        if not t.is_cuda:
            self.host = t.detach().clone()
            return
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if not host.is_pinned():
            raise RuntimeError(
                f"remat offload of {name!r}: no pinned host memory for "
                f"{self.nbytes} bytes")
        COUNTS["pinned"] += 1
        side = _side_stream(t.device)
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            host.copy_(t.detach(), non_blocking=True)
        # The block's memory is not reused before the copy has read it.
        t.record_stream(side)
        self.host = host

    def fetch(self, device: torch.device) -> None:
        """Start the copy back (a recompute begins)."""
        if self.host is None or self.fetched is not None:
            return
        COUNTS["h2d"] += self.nbytes
        if device.type != "cuda":
            self.fetched = self.host
            return
        side = _side_stream(device)
        dev = torch.empty(self.host.shape, dtype=self.host.dtype,
                          device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            dev.copy_(self.host, non_blocking=True)
        dev.record_stream(side)
        self.ready = side.record_event()
        self.fetched = dev

    def get(self) -> torch.Tensor:
        if self.device is not None:
            return self.device
        if self.ready is not None:
            torch.cuda.current_stream(self.fetched.device).wait_event(
                self.ready)
        return self.fetched


class KeptSites:
    """The kept sites of one checkpointed block call: its first run keeps
    each kept site's tensors in call order, each later run (a recompute)
    hands them back in the same order."""

    def __init__(self, policy: RematPolicy, device: torch.device):
        self.saved = frozenset(policy.saved_names)
        self.offload = frozenset(policy.offload_names)
        self.dots = policy.dots
        self.device = device
        self.entries: List[Tuple[Optional[_Kept], ...]] = []
        self.runs = 0
        self.at = 0

    def mode(self, names: Sequence[str], dot: str = "") -> Optional[str]:
        """``"offload"``, ``"save"`` or None (not kept) for a site with
        ``names`` that is a product of kind ``dot`` (``"plain"``,
        ``"batch"`` or ``""``, not a dot)."""
        if any(n in self.offload for n in names):
            return "offload"
        if any(n in self.saved for n in names):
            return "save"
        if dot and (self.dots == "all" or (self.dots == "no_batch"
                                           and dot == "plain")):
            return "save"
        return None

    def name(self, names: Sequence[str], dot: str = "") -> str:
        """The name a kept site's bytes count under: its first name the
        policy keeps, else its first name, else ``"dot"`` or
        ``"batch_dot"`` (a product kept as a dot)."""
        for n in names:
            if n in self.offload or n in self.saved:
                return n
        if names:
            return names[0]
        return "batch_dot" if dot == "batch" else "dot"

    @property
    def first(self) -> bool:
        return self.runs == 1

    def begin(self) -> None:
        self.runs += 1
        self.at = 0
        if self.runs > 1:
            for entry in self.entries:
                for kept in entry:
                    if kept is not None:
                        kept.fetch(self.device)

    def keep(self, tensors: Sequence[Optional[torch.Tensor]],
             names: Sequence[str], modes: Sequence[Optional[str]]) -> None:
        self.entries.append(tuple(
            None if mode is None else _Kept(t, name, mode == "offload")
            for t, name, mode in zip(tensors, names, modes)))

    def replay(self) -> Tuple[Optional[torch.Tensor], ...]:
        entry = self.entries[self.at]
        self.at += 1
        for kept in entry:
            if kept is not None:
                COUNTS["replays"][kept.name] += 1
        return tuple(None if kept is None else kept.get() for kept in entry)


#: The :class:`KeptSites` of the checkpointed block call in progress.
_STORE: Optional[KeptSites] = None


def active() -> Optional[KeptSites]:
    """The store of the block call in progress, or None (no selective
    policy, or outside autograd)."""
    return _STORE if _STORE is not None and torch.is_grad_enabled() \
        else None


@contextlib.contextmanager
def _activate(store: KeptSites):
    global _STORE
    prev, _STORE = _STORE, store
    store.begin()
    try:
        yield
    finally:
        _STORE = prev


def _keeps_anything(policy: RematPolicy) -> bool:
    return bool(policy.saved_names or policy.offload_names or policy.dots)


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def run(name: Union[str, RematPolicy], fn: Callable, *args):
    """``fn(*args)`` (one block) under the policy ``name``: see the
    module docstring."""
    policy = resolve(name)
    if policy.name == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if not _keeps_anything(policy):
        return checkpoint(fn, *args, use_reentrant=False)
    store = KeptSites(policy, _device_of(args))

    def body(*a):
        with _activate(store):
            return fn(*a)

    return checkpoint(body, *args, use_reentrant=False)


# ---- products as sites --------------------------------------------------------


def _is_column_major(t: torch.Tensor) -> bool:
    return t.dim() == 2 and t.stride(0) == 1 and t.stride(1) == t.shape[0]


class _Product(torch.autograd.Function):
    """``a @ b`` (``mm`` for 2-D operands, ``bmm`` for 3-D), viewed as
    ``shape`` when given, plus ``bias``: computed (``kept`` None) or
    handed back (``kept``).  Either way it saves ``a`` and ``b`` and its
    backward is the products' own (autograd's ``mm``/``bmm``, ``view``
    and broadcast-add formulas, in their order), so a replay gives the
    gradients a plain run gives."""

    @staticmethod
    def forward(ctx, kept, a, b, bias, shape):
        ctx.save_for_backward(a, b)
        ctx.mm_shape = tuple(a.shape[:-1]) + (b.shape[-1],)
        ctx.shape = shape
        ctx.bias_shape = None if bias is None else tuple(bias.shape)
        if kept is not None:
            return kept.view_as(kept)
        y = torch.mm(a, b) if a.dim() == 2 else torch.bmm(a, b)
        if shape is not None:
            y = y.view(shape)
        if bias is not None:
            y = y + bias
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        need_a, need_b, need_bias = ctx.needs_input_grad[1:4]
        dbias = dy.sum_to_size(ctx.bias_shape) if need_bias else None
        d = dy.reshape(ctx.mm_shape) if ctx.shape is not None else dy
        da = db = None
        if a.dim() == 2:
            if need_a:
                da = (b.mm(d.t()).t() if _is_column_major(a)
                      else d.mm(b.t()))
            if need_b:
                db = (d.t().mm(a).t() if _is_column_major(b)
                      else a.t().mm(d))
        else:
            if need_a:
                da = d.bmm(b.transpose(1, 2))
            if need_b:
                db = a.transpose(1, 2).bmm(d)
        return None, da, db, dbias, None


def _plain_product(a, b, bias, shape):
    y = a @ b if a.dim() == 2 else torch.bmm(a, b)
    if shape is not None:
        y = y.reshape(shape)
    if bias is not None:
        y = y + bias
    return y


def product(a: torch.Tensor, b: torch.Tensor, *,
            bias: Optional[torch.Tensor] = None,
            shape: Optional[Sequence[int]] = None,
            names: Sequence[str] = (), dot: str = "plain") -> torch.Tensor:
    """``(a @ b).reshape(shape) + bias`` (``a``, ``b`` 2-D, or 3-D for a
    batched product, ``dot="batch"``) as a remat site named ``names``:
    kept where the active policy keeps it, plain otherwise."""
    store = active()
    mode = store.mode(names, dot) if store is not None else None
    if mode is None:
        return _plain_product(a, b, bias, shape)
    shape = None if shape is None else tuple(shape)
    if store.first:
        y = _Product.apply(None, a, b, bias, shape)
        store.keep((y,), (store.name(names, dot),), (mode,))
        return y
    (kept,) = store.replay()
    return _Product.apply(kept, a, b, bias, shape)


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
           names: Sequence[str] = ()) -> torch.Tensor:
    """A two-operand einsum (no index repeated within an operand, every
    index of ``a`` or ``b`` in the other or in the output) as one
    ``bmm`` over the batch, free and contracted indices, the product a
    remat site (a dot with batch dimensions when there are batch
    indices).  The same operations run with and without a policy."""
    lhs, out = spec.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    batch = [c for c in out if c in sa and c in sb]
    free_a = [c for c in out if c in sa and c not in sb]
    free_b = [c for c in out if c in sb and c not in sa]
    contract = [c for c in sa if c in sb and c not in out]
    size = {c: n for s, t in ((sa, a), (sb, b)) for c, n in zip(s, t.shape)}

    def prod(idx):
        n = 1
        for c in idx:
            n *= size[c]
        return n

    a3 = a.permute([sa.index(c) for c in batch + free_a + contract]
                   ).reshape(prod(batch), prod(free_a), prod(contract))
    b3 = b.permute([sb.index(c) for c in batch + contract + free_b]
                   ).reshape(prod(batch), prod(contract), prod(free_b))
    y = product(a3, b3, names=names, dot="batch" if batch else "plain")
    order = batch + free_a + free_b
    y = y.view([size[c] for c in order])
    return y.permute([order.index(c) for c in out])



class _IndexAdd(torch.autograd.Function):
    """``zeros[n, ...].index_add(0, index, rows)`` computed or handed back
    (``kept``); it saves ``index``, and its backward is ``index_add``'s:
    the rows' gradient is the output's at ``index``."""

    @staticmethod
    def forward(ctx, kept, index, rows, n):
        ctx.save_for_backward(index)
        if kept is not None:
            return kept.view_as(kept)
        return rows.new_zeros((n,) + tuple(rows.shape[1:])).index_add(
            0, index, rows)

    @staticmethod
    def backward(ctx, dy):
        (index,) = ctx.saved_tensors
        drows = dy.index_select(0, index) if ctx.needs_input_grad[2] \
            else None
        return None, None, drows, None


def index_add_rows(n: int, index: torch.Tensor, rows: torch.Tensor,
                   names: Sequence[str] = ()) -> torch.Tensor:
    """``rows`` summed into ``n`` zero rows at ``index`` (an MoE grouped
    dispatch's combine) as a remat site named ``names`` (not a dot)."""
    store = active()
    mode = store.mode(names) if store is not None else None
    if mode is None:
        return rows.new_zeros((n,) + tuple(rows.shape[1:])).index_add(
            0, index, rows)
    if store.first:
        y = _IndexAdd.apply(None, index, rows, n)
        store.keep((y,), (store.name(names),), (mode,))
        return y
    (kept,) = store.replay()
    return _IndexAdd.apply(kept, index, rows, n)
