"""Quantized collectives: the int8 wire format for the data-parallel
gradient (port of ``dlrover_tpu/parallel/quantized_collectives.py``).

The scheme is the EQuARX shape: two quantized phases instead of one fp
all-reduce.

  1. reduce-scatter phase: each member block-quantizes its chunks and
     exchanges int8 blocks + fp32 scales (one all-to-all, or ``n - 1``
     ring hops re-quantizing the travelling partial); the owner
     dequantizes and sums in fp32;
  2. broadcast phase: owners re-quantize their reduced chunk and
     all-gather int8 + scales.

The block format is 256 values a block, scale ``absmax / 127`` (1 where
the block is all zero), codes ``clip(round(x / scale), -127, 127)``: K5a
and K5b (``ops/quantization.quantize`` / ``dequantize``) compute exactly
this, so on a CUDA tensor every wire payload is quantized by K5a and
dequantized by K5b; a CPU tensor takes their plain versions.  Another
block size has no kernel and raises on CUDA.  Wire bytes: ``1 + 4/256``
a value per phase against 2 (bf16) or 4 (fp32).

The reference calls these inside ``shard_map``, where every member holds
the value the collective reduces.  The port calls them on each rank's
own tensor over a :class:`~dlrover_tpu_torch.parallel.wire.Wire`; given
the same per-member inputs they compute what the reference computes
(``tests/test_torch_collectives.py``).  ``mean`` divides by the member
count; a data-parallel step passes partial gradients already divided by
the global token count and sums them (``mean=False``).

The MoE dispatch's transports (the expert axis): :func:`all_to_all`
(``"a2a"``) and :func:`quantized_all_to_all` (``"a2a_int8"``: each chunk
block-quantized once at its source, K5a, the int8 payload and fp32
scales exchanged, what is received dequantized in one K5b launch), each
differentiable with the inverse exchange as its backward (on the same
wire: straight through the rounding, as the reference's ``_qa2a_bwd``);
:func:`a2a_wire_bytes` prices one leg.

Local SGD's transport (``parallel/local_sgd.py``):
:func:`quantized_process_allgather` gathers every process's delta tree
on the int8 wire format: each leaf block-quantized at its source (one
K5a launch a leaf), every leaf's codes and scales in one all-gather,
each process's payload dequantized leaf by leaf (one K5b launch a leaf
and process); :func:`process_allgather_bytes` prices it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.ops import quantization
from dlrover_tpu_torch.parallel.wire import Wire

# Below this payload the n-1 quantized ring hops are pure latency: the
# one-shot all-to-all (two logical hops) wins.
RING_MIN_BYTES = 1 << 20


def axis_crosses_dcn(group: Wire) -> bool:
    """Whether the group's members span more than one host (so its wire
    leaves the host's own interconnect).  One collective, the first time
    a group is asked."""
    return len(set(group.host_names())) > 1


def select_reduce_algo(
    n: int, payload_bytes: int = 0, crosses_dcn: bool = False
) -> str:
    """Topology-aware algorithm choice: "oneshot" | "ring".

    The one-shot (all-to-all, one quantization round) wins when latency
    dominates: tiny groups, small payloads, or a wire across hosts.  The
    ring (``n-1`` neighbor hops, quantizing the travelling partial each
    hop) is bandwidth-optimal per element; its error grows with ``n``.
    """
    if crosses_dcn or n <= 2:
        return "oneshot"
    if payload_bytes and payload_bytes < RING_MIN_BYTES:
        return "oneshot"
    return "ring"


def _block_quant(x: torch.Tensor, block: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N] fp -> (int8 [N], scales fp32 [N/block]); N a multiple of
    ``block``.  K5a on a CUDA tensor."""
    if block != quantization.BLOCK:
        if x.is_cuda:
            raise ValueError(
                f"block {block} has no kernel: K5a quantizes blocks of "
                f"{quantization.BLOCK}")
        rows = x.float().reshape(-1, block)
        q, scales = quantization._absmax_int8(rows)
        return q.reshape(-1), scales
    q, scales = quantization.quantize(x)
    return q.reshape(-1), scales


def _block_dequant(q: torch.Tensor, scales: torch.Tensor, block: int
                   ) -> torch.Tensor:
    """The inverse: fp32 [N].  K5b on a CUDA tensor."""
    n = q.numel()
    if block != quantization.BLOCK:
        if q.is_cuda:
            raise ValueError(
                f"block {block} has no kernel: K5b dequantizes blocks of "
                f"{quantization.BLOCK}")
        return (q.reshape(-1, block).float() * scales[:, None]).reshape(-1)
    return quantization.dequantize(q.reshape(-1, block), scales, (n,))


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """``rows[0] + rows[1] + ...`` in member order."""
    acc = rows[0]
    for j in range(1, rows.shape[0]):
        acc = acc + rows[j]
    return acc


def _oneshot_rs(chunks: torch.Tensor, group: Wire, n: int, block: int
                ) -> torch.Tensor:
    """One-shot reduce-scatter core: quantize all n chunks, one
    all-to-all so member i receives every member's chunk i, dequantize +
    fp32 sum.  ``chunks`` is fp32 [n, shard], shard % block == 0; returns
    this member's reduced fp32 [shard]."""
    shard = chunks.shape[1]
    q, scales = _block_quant(chunks.reshape(-1), block)
    q_recv = torch.empty_like(q)
    s_recv = torch.empty_like(scales)
    group.all_to_all(q_recv, q)
    group.all_to_all(s_recv, scales)
    q_recv = q_recv.reshape(n, shard)
    s_recv = s_recv.reshape(n, shard // block)
    parts = torch.stack([_block_dequant(q_recv[j], s_recv[j], block)
                         for j in range(n)])
    return _sum_rows(parts)


def _ring_rs(chunks: torch.Tensor, group: Wire, n: int, block: int
             ) -> torch.Tensor:
    """Ring reduce-scatter core: ``n-1`` neighbor hops, the travelling
    partial re-quantized per hop.  At hop t member i sends the partial for
    chunk (i - t - 1) mod n and receives chunk (i - t - 2) mod n, adding
    its local copy; after n-1 hops member i holds chunk i, reduced."""
    idx = group.rank
    acc = chunks[(idx - 1) % n]
    for t in range(n - 1):
        q, s = _block_quant(acc, block)
        q_in, s_in = torch.empty_like(q), torch.empty_like(s)
        group.shift(q, q_in)
        group.shift(s, s_in)
        received = _block_dequant(q_in, s_in, block)
        acc = received + chunks[(idx - t - 2) % n]
    return acc


def _gather_blocks(q: torch.Tensor, s: torch.Tensor, group: Wire,
                   algo: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every member's (int8, scales) payload, stacked by source member.
    The ring passes each payload ``n - 1`` hops unchanged, so both
    algorithms give the same bits."""
    n = group.size
    if algo == "ring":
        qs, ss = [None] * n, [None] * n
        qs[group.rank], ss[group.rank] = q, s
        cur_q, cur_s = q, s
        for t in range(n - 1):
            nq, ns = torch.empty_like(q), torch.empty_like(s)
            group.shift(cur_q, nq)
            group.shift(cur_s, ns)
            src = (group.rank - t - 1) % n
            qs[src], ss[src] = nq, ns
            cur_q, cur_s = nq, ns
        return torch.stack(qs), torch.stack(ss)
    q_all = torch.empty((n,) + tuple(q.shape), dtype=q.dtype,
                        device=q.device)
    s_all = torch.empty((n,) + tuple(s.shape), dtype=s.dtype,
                        device=s.device)
    group.all_gather(q_all, q.contiguous())
    group.all_gather(s_all, s.contiguous())
    return q_all, s_all


def quantized_all_reduce(
    x: torch.Tensor,
    group: Wire,
    block: int = 256,
    mean: bool = True,
    algo: str = "oneshot",
) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` with an int8 wire format.  The
    result is identical on every member (quantization error included).
    ``algo`` selects the reduce-scatter phase's lowering; the broadcast
    phase is an all-gather either way."""
    n = group.size
    if n == 1:
        return x
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    shard = -(-flat.numel() // (n * block)) * block
    flat = F.pad(flat, (0, shard * n - flat.numel()))
    chunks = flat.reshape(n, shard)
    rs = _ring_rs if algo == "ring" else _oneshot_rs
    reduced = rs(chunks, group, n, block)
    if mean:
        reduced = reduced / n
    q2, s2 = _block_quant(reduced, block)
    q_all, s_all = _gather_blocks(q2, s2, group, "oneshot")
    out = torch.cat([_block_dequant(q_all[j], s_all[j], block)
                     for j in range(n)])
    return out[: x.numel()].reshape(orig_shape).to(orig_dtype)


def quantized_reduce_scatter(
    x: torch.Tensor,
    group: Wire,
    *,
    dim: int = 0,
    block: int = 256,
    mean: bool = True,
    algo: str = "oneshot",
) -> torch.Tensor:
    """Reduce-scatter ``x`` over ``group`` on the int8 wire format.
    Member ``i`` returns chunk ``i`` of the reduction, split along ``dim``
    (which must divide evenly by the group size): the ZeRO-1 gradient leg,
    feeding the shard-local optimizer update."""
    n = group.size
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(
            f"reduce-scatter dim {dim} (size {x.shape[dim]}) must divide "
            f"by the {n}-member group"
        )
    orig_dtype = x.dtype
    moved = torch.movedim(x, dim, 0)
    chunk_shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
    chunks = moved.float().reshape(n, -1)
    csize = chunks.shape[1]
    padded = -(-csize // block) * block
    chunks = F.pad(chunks, (0, padded - csize))
    rs = _ring_rs if algo == "ring" else _oneshot_rs
    reduced = rs(chunks, group, n, block)
    if mean:
        reduced = reduced / n
    out = reduced[:csize].reshape(chunk_shape)
    return torch.movedim(out, 0, dim).to(orig_dtype)


def quantized_all_gather(
    x: torch.Tensor,
    group: Wire,
    *,
    dim: int = 0,
    block: int = 256,
    algo: str = "oneshot",
) -> torch.Tensor:
    """All-gather ``x`` over ``group`` on the int8 wire format: member
    ``i`` contributes its shard, every member returns the ``n`` shards
    concatenated along ``dim`` in member order, each quantized once at its
    source (the result is identical everywhere).  "oneshot" and "ring"
    give the same bits.  The ZeRO-1 re-replication leg."""
    n = group.size
    if n == 1:
        return x
    orig_dtype = x.dtype
    moved = torch.movedim(x, dim, 0)
    flat = moved.float().reshape(-1)
    padded = -(-flat.numel() // block) * block
    q, s = _block_quant(F.pad(flat, (0, padded - flat.numel())), block)
    q_all, s_all = _gather_blocks(q, s, group, algo)
    shards = torch.stack([_block_dequant(q_all[j], s_all[j], block)
                          for j in range(n)])
    out = shards[:, : flat.numel()].reshape((n,) + tuple(moved.shape))
    out = out.reshape((n * moved.shape[0],) + tuple(moved.shape[1:]))
    return torch.movedim(out, 0, dim).to(orig_dtype)



# -- the MoE dispatch's all-to-all ------------------------------------------------


def a2a_wire_bytes(n_elems: int, quant: str = "none", *, block: int = 256,
                   elem_bytes: int = 4) -> int:
    """Modeled wire bytes of one all-to-all leg over ``n_elems`` elements
    (the reference's pricing twin of :func:`quantized_all_to_all`): 1 byte
    a value and a 4-byte fp32 scale a block on the int8 wire, against
    ``elem_bytes`` a value on the plain one.  Each chunk pads to whole
    blocks, so a chunk of whole blocks is priced exactly."""
    if quant == "int8":
        return n_elems + (-(-n_elems // block)) * 4
    return n_elems * elem_bytes


def _split_chunks(x: torch.Tensor, split_axis: int, n: int, what: str
                  ) -> torch.Tensor:
    """``x`` as ``[n, chunk...]``: its ``n`` chunks along ``split_axis``,
    the split axis first in each chunk."""
    if x.shape[split_axis] % n:
        raise ValueError(
            f"{what} split axis {split_axis} (size {x.shape[split_axis]}) "
            f"must divide by the {n}-member group")
    moved = torch.movedim(x, split_axis, 0)
    return moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))


def _merge_pieces(pieces: torch.Tensor, split_axis: int, concat_axis: int
                  ) -> torch.Tensor:
    """The received ``[n, chunk...]`` (each chunk's split axis first)
    concatenated along ``concat_axis`` in member order, the chunks' own
    dimension order restored (the tiled all-to-all's contract)."""
    pieces = torch.movedim(pieces, 1, 1 + split_axis)
    out = torch.movedim(pieces, 0, concat_axis)
    shape = (tuple(out.shape[:concat_axis])
             + (out.shape[concat_axis] * out.shape[concat_axis + 1],)
             + tuple(out.shape[concat_axis + 2:]))
    return out.reshape(shape)


def _a2a_impl(x: torch.Tensor, group: Wire, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    n = group.size
    chunks = _split_chunks(x, split_axis, n, "all-to-all").contiguous()
    out = torch.empty_like(chunks)
    group.all_to_all(out, chunks)
    return _merge_pieces(out, split_axis, concat_axis)


def _qa2a_impl(x: torch.Tensor, group: Wire, split_axis: int,
               concat_axis: int, block: int) -> torch.Tensor:
    n = group.size
    chunks = _split_chunks(x, split_axis, n, "all-to-all")
    chunk_shape = tuple(chunks.shape[1:])
    rows = chunks.float().reshape(n, -1)
    csize = rows.shape[1]
    padded = -(-csize // block) * block
    # One quantization round at the source; each chunk pads to whole
    # blocks, so a block never spans two members' chunks.
    q, s = _block_quant(F.pad(rows, (0, padded - csize)).reshape(-1), block)
    q_recv, s_recv = torch.empty_like(q), torch.empty_like(s)
    group.all_to_all(q_recv, q)
    group.all_to_all(s_recv, s)
    deq = _block_dequant(q_recv, s_recv, block).reshape(n, padded)
    pieces = deq[:, :csize].reshape((n,) + chunk_shape)
    return _merge_pieces(pieces, split_axis, concat_axis).to(x.dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, block):
        ctx.args = (group, split_axis, concat_axis, block)
        if block:
            return _qa2a_impl(x, group, split_axis, concat_axis, block)
        return _a2a_impl(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        # The exact adjoint of the permutation: the inverse exchange, on
        # the same wire (straight through an int8 wire's rounding).
        group, split_axis, concat_axis, block = ctx.args
        if block:
            g = _qa2a_impl(g.contiguous(), group, concat_axis, split_axis,
                           block)
        else:
            g = _a2a_impl(g.contiguous(), group, concat_axis, split_axis)
        return g, None, None, None, None


def all_to_all(x: torch.Tensor, group: Wire, *, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """All-to-all ``x`` over ``group`` (``jax.lax.all_to_all(..., tiled=
    True)``): ``x`` splits into ``n`` chunks along ``split_axis``, chunk
    ``j`` goes to member ``j``, and the ``n`` chunks received are
    concatenated along ``concat_axis`` in member order.  Differentiable:
    the backward is the inverse exchange.  The identity on one member."""
    if group is None or group.size == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis, 0)


def quantized_all_to_all(x: torch.Tensor, group: Wire, *,
                         split_axis: int = 0, concat_axis: int = 0,
                         block: int = 256) -> torch.Tensor:
    """:func:`all_to_all` on the int8 wire format (the reference's
    ``quantized_all_to_all``): each chunk block-quantized once at its
    source (K5a on a CUDA tensor), the int8 payload and fp32 scales
    exchanged, and the received chunks dequantized (K5b) and concatenated
    in ``x``'s dtype: ``a2a_wire_bytes(x.numel(), "int8")`` on the wire
    for chunks of whole blocks.  Differentiable: the backward is the
    inverse exchange on the same int8 wire, straight through the
    rounding.  The identity on one member (no wire, no quantization)."""
    if group is None or group.size == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis, block)


# -- Local SGD's process all-gather -------------------------------------------------


def process_allgather_bytes(numels: List[int], quant: str = "none", *,
                            block: int = 256, elem_bytes: int = 4) -> int:
    """Bytes one process hands the all-gather of a tree of leaves of
    ``numels`` values: ``elem_bytes`` a value on the plain wire; on the
    int8 wire each leaf padded to whole blocks, a byte a value and a
    4-byte fp32 scale a block."""
    if quant == "int8":
        blocks = sum(-(-n // block) for n in numels)
        return blocks * block + blocks * 4
    return sum(numels) * elem_bytes


def quantized_process_allgather(local_tree: Dict[str, torch.Tensor],
                                wire: Optional[Wire] = None,
                                block: int = 256
                                ) -> List[Dict[str, torch.Tensor]]:
    """Every process's ``{name: tensor}`` tree, gathered on the int8 wire
    (the reference's host-level quantized all-gather, Local SGD's outer
    sync transport): each leaf, as fp32 and zero-padded to whole blocks,
    block-quantized to int8 codes and one fp32 scale a block (K5a on a
    CUDA tensor); the codes and scales of every leaf in one all-gather
    over ``wire`` (the world's when None); each process's leaves
    dequantized (K5b) and cast back to their dtype.  Returns ``[tree of
    process 0, tree of process 1, ...]``.  At one process there is no
    wire to compress: the tree itself, exact."""
    n = wire.size if wire is not None else _world_size()
    if n == 1:
        return [local_tree]
    if wire is None:
        wire = Wire()
    names = list(local_tree)
    codes, scales, layout = [], [], []
    for name in names:
        flat = local_tree[name].detach().float().reshape(-1)
        padded = -(-flat.numel() // block) * block
        q, s = _block_quant(F.pad(flat, (0, padded - flat.numel())), block)
        codes.append(q.view(torch.uint8))
        scales.append(s.view(torch.uint8))
        layout.append((padded, s.numel()))
    # Every leaf's codes, then every leaf's scales: each leaf's codes
    # start at a multiple of the block in the payload.
    payload = torch.cat(codes + scales)
    gathered = torch.empty((n, payload.numel()), dtype=torch.uint8,
                           device=payload.device)
    wire.all_gather(gathered, payload)
    total = sum(padded for padded, _ in layout)
    out = []
    for r in range(n):
        row = gathered[r]
        if row.data_ptr() % 16:
            row = row.clone()  # the kernel's vector loads want alignment
        tree, at, at_s = {}, 0, total
        for name, (padded, nblocks) in zip(names, layout):
            leaf = local_tree[name]
            q = row[at:at + padded].view(torch.int8)
            s = row[at_s:at_s + 4 * nblocks].view(torch.float32)
            at += padded
            at_s += 4 * nblocks
            deq = _block_dequant(q, s, block)
            tree[name] = deq[:leaf.numel()].reshape(leaf.shape).to(
                leaf.dtype)
        out.append(tree)
    return out


def process_allgather(local_tree: Dict[str, torch.Tensor],
                      wire: Optional[Wire] = None
                      ) -> List[Dict[str, torch.Tensor]]:
    """Every process's ``{name: tensor}`` tree on the plain wire (the
    reference's ``multihost_utils.process_allgather``): the leaves of
    one dtype flattened into one all-gather over ``wire`` (the world's
    when None).  At one process, the tree itself."""
    n = wire.size if wire is not None else _world_size()
    if n == 1:
        return [local_tree]
    if wire is None:
        wire = Wire()
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for name, leaf in local_tree.items():
        by_dtype.setdefault(leaf.dtype, []).append(name)
    for names in by_dtype.values():
        flat = torch.cat([local_tree[k].detach().reshape(-1) for k in names])
        gathered = torch.empty((n, flat.numel()), dtype=flat.dtype,
                               device=flat.device)
        wire.all_gather(gathered, flat)
        for r in range(n):
            at = 0
            for k in names:
                size = local_tree[k].numel()
                out[r][k] = gathered[r, at:at + size].reshape(
                    local_tree[k].shape)
                at += size
    return [{k: tree[k] for k in local_tree} for tree in out]


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
