"""Ring attention over the ``seq`` axis (port of
``dlrover_tpu/parallel/ring_attention.py``).

Each rank of a seq group keeps its slice of the queries, ``[B, S / n, H,
D]``, and the keys, values and segment ids hop around the ring
(``parallel/wire.Wire.shift``): at step ``i`` rank ``r`` holds the chunk of
rank ``r - i`` (mod n) and merges the chunk's attention into online-softmax
statistics, with the reference's math: the queries in fp32, K and V in
their own dtype, the probabilities cast to V's dtype before the PV
product, the ``m == NEG_INF`` guards.  Under the causal mask a chunk that
lies wholly in the future (its source rank after ``r``) is skipped, though
it still hops.  Each hop is posted before the chunk's math and waited
after it, as XLA overlaps the reference's ``ppermute`` with its einsums.

The backward recomputes each chunk's scores from the queries, the chunk
and the forward's log-sum-exp; no chunk's scores are kept (the reference
checkpoints each step).  K, V and the segment ids hop around the ring
again, and each chunk's dK/dV accumulators (fp32) travel with it, one hop
behind, and come home with one more hop after the last step.  Both
directions take a chunk ``ROW_BLOCK`` query rows at a time and work on a
tile's scores in place, so a call's device peak holds less than one
chunk's scores.  The chunk products are ``torch.matmul``: the reference
computes them with einsums outside any Pallas kernel, so no kernel of the
port runs here.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
#: Query rows whose scores are computed at once.  A chunk's scores at
#: Llama-2 7B's 32 heads and 2048 tokens a rank are 512 MiB of fp32; a
#: tile of 512 rows is a quarter of that, so the backward's scores and
#: dS of one tile together stay under one chunk's scores.
ROW_BLOCK = 512


def _scores(q, k_t, q_pos, k_pos, seg_q, seg_k, scale, causal):
    """Masked fp32 scores ``[B, H, Sq, Sk]`` of one tile (``k_t`` the
    chunk's keys in fp32, transposed), NEG_INF where masked, and the mask
    ``[B, 1, Sq, Sk]``."""
    s = torch.matmul(q, k_t).mul_(scale)
    mask = seg_q[:, None, :, None] == seg_k[:, None, None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return s.masked_fill_(~mask, NEG_INF), mask


def _row_tiles(n):
    return [slice(r, min(r + ROW_BLOCK, n)) for r in range(0, n, ROW_BLOCK)]


def _chunk_attention(q, k_c, v_c, q_pos, k_pos, seg_q, seg_k, scale, causal):
    """The reference's unnormalised blockwise attention: ``(m, l, o)``
    with ``m, l [B, H, Sq, 1]`` and ``o = sum_j exp(s_ij - m_i) v_j``,
    ``ROW_BLOCK`` query rows at a time, each tile's scores in place."""
    k_t = k_c.float().transpose(-1, -2)
    vf = v_c.float()
    ms, ls, os_ = [], [], []
    for rows in _row_tiles(q.shape[2]):
        s, _ = _scores(q[:, :, rows], k_t, q_pos[rows], k_pos,
                       seg_q[:, rows], seg_k, scale, causal)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_().masked_fill_(m == NEG_INF, 0.0)
        ls.append(p.sum(dim=-1, keepdim=True))
        ms.append(m)
        # p in V's dtype, the product accumulated in fp32 (the reference's
        # preferred_element_type).
        if v_c.dtype != p.dtype:
            p.copy_(p.to(v_c.dtype))
        os_.append(torch.matmul(p, vf))
        del s, p
    return torch.cat(ms, 2), torch.cat(ls, 2), torch.cat(os_, 2)


def _chunk_backward(dq, dk, dv, qf, do, delta, lse, k_c, v_c, q_pos, k_pos,
                    seg_q, seg_k, scale, causal):
    """One chunk's share of the gradients, added into ``dq`` (this rank's
    queries) and ``dk``/``dv`` (the chunk's accumulators): the
    probabilities recomputed from ``lse``, ``ROW_BLOCK`` query rows at a
    time, each tile's scores and dS in place."""
    kf = k_c.float()
    k_t = kf.transpose(-1, -2)
    v_t = v_c.float().transpose(-1, -2)
    for rows in _row_tiles(qf.shape[2]):
        s, mask = _scores(qf[:, :, rows], k_t, q_pos[rows], k_pos,
                          seg_q[:, rows], seg_k, scale, causal)
        lse_r, do_r = lse[:, :, rows], do[:, :, rows]
        p = s.sub_(lse_r).exp_().masked_fill_(~mask, 0.0)
        p.masked_fill_(lse_r <= NEG_INF, 0.0)
        del s, mask
        dv += torch.matmul(p.transpose(-1, -2), do_r)
        ds = torch.matmul(do_r, v_t).sub_(delta[:, :, rows]).mul_(p)
        del p
        dq[:, :, rows] += torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qf[:, :, rows]) * scale
        del ds


class _Ring:
    """The hops of one call: the group's wire, size and this rank's
    index (size 1: no wire, no hop)."""

    def __init__(self, group):
        self.wire = group.wire if group is not None else None
        self.n = group.size if group is not None else 1
        self.idx = group.rank if group is not None else 0

    def post(self, tensors):
        """Post the hop of ``tensors`` to the next rank: ``(pending,
        received)``."""
        got = [torch.empty_like(t) for t in tensors]
        return self.wire.shift(list(tensors), got, async_op=True), got


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal, group):
        ring = _Ring(group)
        n, idx = ring.n, ring.idx
        b, sl, h, d = q.shape
        qf = q.transpose(1, 2).float()
        kf = k.transpose(1, 2).contiguous()
        vf = v.transpose(1, 2).contiguous()
        local = torch.arange(sl, device=q.device)
        q_pos = idx * sl + local
        m = torch.full((b, h, sl, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, sl, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, sl, d), dtype=torch.float32,
                          device=q.device)
        cur = (kf, vf, seg)
        for i in range(n):
            pending = None
            if i < n - 1:
                pending, nxt = ring.post(cur)
            src = (idx - i) % n
            if not causal or src <= idx:
                k_pos = src * sl + local
                m_c, l_c, o_c = _chunk_attention(
                    qf, cur[0], cur[1], q_pos, k_pos, seg, cur[2], scale,
                    causal)
                m_new = torch.maximum(m, m_c)
                alpha = torch.exp(m - m_new)
                alpha = torch.where(m == NEG_INF, torch.zeros_like(alpha),
                                    alpha)
                beta = torch.exp(m_c - m_new)
                beta = torch.where(m_c == NEG_INF, torch.zeros_like(beta),
                                   beta)
                m, l = m_new, l * alpha + l_c * beta
                acc = acc * alpha + o_c * beta
                del m_c, l_c, o_c
            if pending is not None:
                pending.wait()
                cur = tuple(nxt)
        out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
        # The log-sum-exp of each row; rows that saw no key (l == 0) stay
        # at NEG_INF, and their probabilities at 0 in the backward.
        lse = torch.where(l > 0, m + torch.log(torch.where(
            l > 0, l, torch.ones_like(l))), torch.full_like(l, NEG_INF))
        ctx.save_for_backward(qf, kf, vf, seg, out, lse)
        ctx.scale, ctx.causal, ctx.group = scale, causal, group
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, seg, out, lse = ctx.saved_tensors
        scale, causal = ctx.scale, ctx.causal
        ring = _Ring(ctx.group)
        n, idx = ring.n, ring.idx
        sl = qf.shape[2]
        do = dout.transpose(1, 2).float()
        delta = (do * out).sum(dim=-1, keepdim=True)
        local = torch.arange(sl, device=qf.device)
        q_pos = idx * sl + local
        dq = torch.zeros_like(qf)
        dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
        dv = torch.zeros(vf.shape, dtype=torch.float32, device=vf.device)
        cur = (kf, vf, seg)
        for i in range(n):
            pending = None
            if i < n - 1:
                pending, nxt = ring.post(cur)
            src = (idx - i) % n
            if not causal or src <= idx:
                _chunk_backward(dq, dk, dv, qf, do, delta, lse, cur[0],
                                cur[1], q_pos, src * sl + local, seg, cur[2],
                                scale, causal)
            if n > 1:
                # This chunk's accumulators go on with it (after the last
                # step, home to the rank that holds the chunk).
                got = [torch.empty_like(dk), torch.empty_like(dv)]
                ring.wire.shift([dk, dv], got)
                dk, dv = got
            if pending is not None:
                pending.wait()
                cur = tuple(nxt)
        q_dt, k_dt, v_dt = ctx.dtypes
        return (dq.transpose(1, 2).to(q_dt), dk.transpose(1, 2).to(k_dt),
                dv.transpose(1, 2).to(v_dt), None, None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    group=None,
) -> torch.Tensor:
    """Attention on this rank's slice ``[B, S / n, H, D]`` of the sequence
    over the seq group ``group`` (``parallel/sharding.SeqGroup``; None: a
    ring of one).  ``segment_ids`` ``[B, S / n]`` (zeros when None) hop
    with K and V.  GQA: K/V heads are repeated to the query heads before
    the ring (the ring splits the sequence, not the heads)."""
    b, sl, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    if segment_ids is None:
        segment_ids = torch.zeros((b, sl), dtype=torch.int32,
                                  device=q.device)
    if k.shape[2] != h:
        group_size = h // k.shape[2]
        k = k.repeat_interleave(group_size, dim=2)
        v = v.repeat_interleave(group_size, dim=2)
    return _RingAttention.apply(q, k, v,
                                segment_ids.to(torch.int32).contiguous(),
                                scale, causal, group)
