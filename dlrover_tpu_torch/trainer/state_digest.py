"""Train-state digest for silent-data-corruption detection (port of
``dlrover_tpu/trainer/state_digest.py``).

Every replica of one train state holds the same bits, so one uint32 per
replica turns that invariant into a vote (the master's digest ledger,
``master/speed_monitor.SpeedMonitor.record_digest``).  Construction, as
in the reference: each leaf's raw bytes are summed (mod 2^32), then
folded into a running accumulator with an odd multiplier, ``acc = acc * 1000003 + leaf_sum`` (mod 2^32).
The multiplier is invertible mod 2^32, so one flipped bit anywhere
changes the digest.  This is a corruption detector, not a hash.

The reference's digest is a jitted reduction, not a Pallas kernel.  Here
the per-leaf byte sums of CUDA leaves are one launch of a hand-written
kernel (``ops/csrc/byte_sums.cu``: the leaves laid out as chunks of at
most ``CHUNK_BYTES`` in a table uploaded from pinned memory, every byte
read once, each block's sum added to its leaf's with one integer atomic;
counted in :data:`LAUNCHES`), the fold PyTorch ops; no host sync: the
value stays a 0-d int64 tensor until a report formats it.  The uint32
arithmetic runs in int64 under a mask.

CPU leaves take the kernel's plain version (:func:`byte_sums_reference`,
PyTorch ops on any device): few launches and small temporaries.  A
leaf's bytes
are summed in rows of ``ROW_BYTES`` (128: a row's sum fits int16,
128 * 255 < 2^15), the rows widened to int16 ``GROUP_ROWS`` rows a
launch (128 MiB of bytes to 256 MiB; a wider accumulator casts its whole
input first, and the 3.37 GB GPT-2 1.5B train state widened to int64
would be 27 GB).  A leaf of whole rows and at least ``DIRECT_ROWS`` rows
is summed where it lies; the others are packed, each zero-padded to
whole rows, into one buffer (``torch.cat``, a launch for many leaves) and
summed there.  Every row sum lands in one int16 vector, and each leaf's
sum is the difference of that vector's int64 prefix sums at the leaf's
first and last rows: one gather for all the leaves, not launches for
each.  The fold is vectorised: with ``p_i = M^(n-1-i)`` mod 2^32,
``acc = sum_i s_i p_i`` mod 2^32, each product split at 16 bits of
``p_i`` so it stays below 2^49.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint import shm_handler
from dlrover_tpu_torch.ops import kernel_lib

#: Launches of the byte-sum kernel; a run sets the count to 0 and reads it
#: back to show its path went through the kernel.
LAUNCHES = {"digest_sums": 0}
#: The most bytes of a leaf one block of the kernel sums.
CHUNK_BYTES = 1 << 20
#: The kernel's chunk table row (``struct Chunk`` of ``byte_sums.cu``).
CHUNK_DTYPE = np.dtype([("addr", "<u8"), ("nbytes", "<i8"),
                        ("leaf", "<i8")])
#: Blocks of the kernel per SM.
BLOCKS_PER_SM = 8

MULTIPLIER = 1000003
MASK = 0xFFFFFFFF
ROW_BYTES = 128
GROUP_ROWS = 1 << 20
DIRECT_ROWS = 1 << 13

_POWERS: Dict[Tuple[int, str], torch.Tensor] = {}
_SPANS: Dict[Tuple[Any, ...], torch.Tensor] = {}
#: Per CUDA device: the pinned buffer the kernel's chunk table is staged
#: in, and the event after the copy that last read it.
_STAGING: Dict[str, Tuple[torch.Tensor, Any]] = {}


def _int_sum(value: int) -> int:
    """Byte sum of the reference's int32 step counter."""
    return int(np.asarray(value, np.int32).reshape(1).view(np.uint8)
               .sum(dtype=np.int64))


def _bytes(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's raw bits as a flat uint8 tensor (a view when it is
    contiguous)."""
    t = leaf.detach()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.reshape(-1).contiguous().view(torch.uint8)


def _upload(values: List[int], device: torch.device) -> torch.Tensor:
    """An int64 host list on ``device`` without a host sync."""
    host = torch.tensor(values, dtype=torch.int64)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _sum_rows(flat: torch.Tensor, out: torch.Tensor) -> None:
    """``out[r]`` = the sum of row ``r`` of ``flat`` (whole rows of
    ``ROW_BYTES`` bytes), ``GROUP_ROWS`` rows a launch."""
    rows = flat.view(-1, ROW_BYTES)
    for at in range(0, rows.shape[0], GROUP_ROWS):
        torch.sum(rows[at:at + GROUP_ROWS], dim=1, dtype=torch.int16,
                  out=out[at:at + GROUP_ROWS])


def chunk_table(addrs: Sequence[int], nbytes: Sequence[int],
                chunk: int = CHUNK_BYTES) -> np.ndarray:
    """The kernel's table: leaf ``i``'s bytes ``[addrs[i], addrs[i] +
    nbytes[i])`` as consecutive chunks of at most ``chunk`` bytes (none for
    an empty leaf), leaf by leaf, as ``CHUNK_DTYPE`` rows."""
    addrs = np.asarray(addrs, np.uint64).reshape(-1)
    nbytes = np.asarray(nbytes, np.int64).reshape(-1)
    per = -(-nbytes // chunk)
    leaf = np.repeat(np.arange(len(nbytes), dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    offset = (np.arange(len(leaf), dtype=np.int64) - first) * chunk
    table = np.empty(len(leaf), CHUNK_DTYPE)
    table["addr"] = addrs[leaf] + offset.astype(np.uint64)
    table["nbytes"] = np.minimum(chunk, nbytes[leaf] - offset)
    table["leaf"] = leaf
    return table


def _lib_fn():
    fn = kernel_lib.load("byte_sums").leaf_byte_sums
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _staged_table(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """``table``'s bytes on ``device``, copied without a host sync from a
    pinned buffer kept for the device (a fresh ``pin_memory`` took 2 to 39
    ms of host time on an H100's host).  The buffer is rewritten only once
    the copy that last read it has run; until then a new one is pinned."""
    raw = table.view(np.uint8).reshape(-1)
    held = _STAGING.get(str(device))
    if held is None or held[0].numel() < raw.size or not held[1].query():
        buf = torch.empty(2 * raw.size, dtype=torch.uint8, pin_memory=True)
    else:
        buf = held[0]
    buf[:raw.size].numpy()[:] = raw
    rows = torch.empty(raw.size, dtype=torch.uint8, device=device)
    rows.copy_(buf[:raw.size], non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    _STAGING[str(device)] = (buf, done)
    return rows


def leaf_sums_kernel(leaves: Sequence[Any],
                     device: torch.device) -> torch.Tensor:
    """Each leaf's raw-byte sum, int64 ``[len(leaves)]`` on ``device``:
    the tensor leaves (on that CUDA device) by one launch of
    ``byte_sums.cu`` (counted in :data:`LAUNCHES`), read where they lie
    (a leaf that is not contiguous is copied first), and a Python int's
    sum written in its place; or an error.  No host sync."""
    device = next((leaf.device for leaf in leaves
                   if isinstance(leaf, torch.Tensor)), device)
    if device.type != "cuda":
        raise ValueError(f"the byte-sum kernel runs on a CUDA device, got "
                         f"{device}")
    sums = torch.zeros(len(leaves), dtype=torch.int64, device=device)
    # ``copies`` keeps the contiguous copies alive until the launch.
    addrs, nbytes, where, copies = [], [], [], []
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor):
            value = _int_sum(_checked_int(leaf))
            if value:
                sums[i].fill_(value)
            continue
        if leaf.device != device:
            raise ValueError(f"the byte-sum kernel takes tensors on one "
                             f"CUDA device, got {device} and {leaf.device}")
        if not leaf.is_contiguous():
            leaf = _bytes(leaf)
            copies.append(leaf)
        addrs.append(leaf.data_ptr())
        nbytes.append(leaf.numel() * leaf.element_size())
        where.append(i)
    table = chunk_table(addrs, nbytes)
    if not len(table):
        return sums
    table["leaf"] = np.asarray(where, np.int64)[table["leaf"]]
    rows = _staged_table(table, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        err = _lib_fn()(rows.data_ptr(), len(table), sums.data_ptr(),
                        min(len(table), BLOCKS_PER_SM * sms),
                        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"byte-sum kernel launch failed: CUDA error {err}")
    LAUNCHES["digest_sums"] += 1
    return sums


def _checked_int(leaf: Any) -> int:
    """A Python int leaf (the JAX package's int32 step counter); anything
    else that is not a tensor is refused."""
    if not isinstance(leaf, int):
        raise TypeError(f"cannot digest a {type(leaf).__name__} leaf")
    return leaf


def _flats(leaves: Sequence[Any]) -> List[torch.Tensor]:
    """The tensor leaves' raw bytes (a Python int is the JAX package's
    int32 step counter; anything else is refused)."""
    flats = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            flats.append(_bytes(leaf))
        else:
            _checked_int(leaf)
    return flats


def byte_sums(leaves: Sequence[Any], device: torch.device) -> torch.Tensor:
    """Each leaf's raw-byte sum (not yet reduced mod 2^32), as int64
    ``[len(leaves)]`` on ``device``.  On a CUDA device one kernel launch
    sums every tensor leaf (:func:`leaf_sums_kernel`); on the CPU the
    plain version does (:func:`byte_sums_reference`)."""
    if device.type == "cuda":
        return leaf_sums_kernel(leaves, device)
    return byte_sums_reference(leaves, device)


def byte_sums_reference(leaves: Sequence[Any], device: torch.device
                        ) -> torch.Tensor:
    """:func:`byte_sums` by PyTorch ops alone, on any device: int16 row
    sums and prefix sums (the module docstring)."""
    flats = _flats(leaves)
    counts = [-(-f.numel() // ROW_BYTES) for f in flats]
    # Row 0 is a zero row, so every leaf's sum is a difference of two
    # prefix sums.
    row_sums = torch.empty(1 + sum(counts), dtype=torch.int16,
                           device=device)
    row_sums[:1].zero_()
    pad = torch.zeros(ROW_BYTES, dtype=torch.uint8, device=device)
    batch: List[torch.Tensor] = []
    batch_at = batch_rows = 0

    def flush():
        if batch:
            packed = torch.cat(batch) if len(batch) > 1 else batch[0]
            _sum_rows(packed, row_sums[batch_at:batch_at + batch_rows])
            batch.clear()

    at = 1
    for flat, n in zip(flats, counts):
        if flat.numel() == n * ROW_BYTES and n >= DIRECT_ROWS:
            flush()
            _sum_rows(flat, row_sums[at:at + n])
        elif n:
            if batch and batch_rows + n > GROUP_ROWS:
                flush()
            if not batch:
                batch_at, batch_rows = at, 0
            batch.append(flat)
            tail = n * ROW_BYTES - flat.numel()
            if tail:
                batch.append(pad[:tail])
            batch_rows += n
        at += n
    flush()
    key = (ROW_BYTES, tuple(counts), str(device))
    spans = _SPANS.get(key)
    if spans is None:
        spans = _SPANS[key] = _upload(np.cumsum([0] + counts).tolist(),
                                      device)
    prefix = torch.cumsum(row_sums, 0, dtype=torch.int64)[spans]
    return _with_ints(leaves, prefix[1:] - prefix[:-1], device)


def _with_ints(leaves: Sequence[Any], sums: torch.Tensor,
               device: torch.device) -> torch.Tensor:
    """The tensor leaves' ``sums`` with the Python ints' byte sums in
    their places."""
    if sums.numel() == len(leaves):
        return sums
    base = [0 if isinstance(leaf, torch.Tensor) else _int_sum(leaf)
            for leaf in leaves]
    where = [i for i, leaf in enumerate(leaves)
             if isinstance(leaf, torch.Tensor)]
    return _upload(base, device).index_copy_(0, _upload(where, device),
                                             sums)


def _powers(n: int, device: torch.device) -> torch.Tensor:
    """``[M^(n-1), ..., M, 1]`` mod 2^32 as int64 on ``device`` (cached;
    uploaded from pinned memory without a host sync)."""
    key = (n, str(device))
    cached = _POWERS.get(key)
    if cached is None:
        values, p = [], 1
        for _ in range(n):
            values.append(p)
            p = (p * MULTIPLIER) & MASK
        host = torch.tensor(values[::-1], dtype=torch.int64)
        if device.type == "cuda":
            cached = host.pin_memory().to(device, non_blocking=True)
        else:
            cached = host.to(device)
        _POWERS[key] = cached
    return cached


def _device_of(leaves: Sequence[Any]) -> torch.device:
    devices = {leaf.device for leaf in leaves
               if isinstance(leaf, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"leaves on more than one device: {devices}")
    return devices.pop() if devices else torch.device("cpu")


def digest_leaves(leaves: Sequence[Any],
                  groups: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Order-sensitive fold of ``leaves`` into one uint32, as a 0-d int64
    tensor on their device (the reference's ``_digest_tree`` of the same
    leaves, bit for bit).

    ``groups`` (counts summing to ``len(leaves)``) folds each run of that
    many consecutive leaves as one leaf: a byte sum is a sum over pieces,
    so the layers of a layer-stacked reference leaf, given in layer order,
    digest as the stacked leaf does.  One byte-sum launch either way."""
    device = _device_of(leaves)
    if not leaves:
        return torch.zeros((), dtype=torch.int64, device=device)
    sums = byte_sums(leaves, device)
    if groups is not None:
        groups = [int(g) for g in groups]
        if sum(groups) != len(leaves) or min(groups) < 1:
            raise ValueError(f"groups {groups} do not partition "
                             f"{len(leaves)} leaves")
        if len(groups) != len(leaves):
            seg = np.repeat(np.arange(len(groups)), groups).tolist()
            sums = torch.zeros(len(groups), dtype=torch.int64,
                               device=device).index_add_(
                0, _upload(seg, device), sums)
    return _fold(sums)


def _fold(sums: torch.Tensor) -> torch.Tensor:
    """The ordered fold of per-leaf byte sums into one uint32."""
    s = sums & MASK
    powers = _powers(sums.numel(), sums.device)
    hi, lo = powers >> 16, powers & 0xFFFF
    terms = ((((s * hi) & 0xFFFF) << 16) + s * lo) & MASK
    return terms.sum() & MASK


def digest_state(state, layout=None, wire=None) -> torch.Tensor:
    """The digest of a ``train_lib.TrainState``: its step counter, then
    what Flash Checkpoint saves of it (parameters and optimizer state).

    Over a group (``wire``: the data group, or the world on a mesh with
    model-parallel axes; with each leaf's ``layout`` on this rank) the
    digest is the whole state's: a leaf split into pieces (a ZeRO-1
    shard, an fsdp or tensor box) has its byte sum completed over the
    group with one all-reduce of the pieces' replica-0 copies, since a
    byte sum is a sum over pieces; a whole leaf keeps this rank's own
    sum, so a rank whose replica differs gives a different digest and the
    master's vote finds it."""
    flat = shm_handler.tree_flatten_with_path(state.checkpoint_tree())
    leaves = [state.step] + [leaf for _, leaf in flat]
    if wire is None or layout is None:
        return digest_leaves(leaves)
    device = _device_of(leaves)
    sums = byte_sums(leaves, device)
    split = [False] + [layout[p].index != tuple(
        (0, d) for d in layout[p].global_shape) for p, _ in flat]
    if any(split):
        mask = torch.tensor(split, device=device)
        mine = torch.tensor([False] + [
            split[i + 1] and layout[p].replica_id == 0
            for i, (p, _) in enumerate(flat)], device=device)
        shared = torch.where(mine, sums, torch.zeros_like(sums))
        wire.all_reduce(shared)
        sums = torch.where(mask, shared, sums)
    return _fold(sums)


def format_digest(value) -> str:
    """Digest (tensor or int) -> canonical 8-hex-digit wire form."""
    return f"{int(value) & MASK:08x}"


def _jax_order(names: Sequence[str]) -> List[str]:
    """The reference's parameter leaves, by the port's names: the block
    parameters stacked over layers (``blocks.<rest>``), every name sorted
    as JAX sorts the nested tree."""
    stacked = set()
    for name in names:
        parts = name.split(".")
        if parts[0] == "blocks" and len(parts) > 2 and parts[1].isdigit():
            stacked.add(".".join(["blocks"] + parts[2:]))
        else:
            stacked.add(name)
    return sorted(stacked, key=lambda n: tuple(n.split(".")))


def flip_mantissa_bit(
    state,
    *,
    bit: int = 10,
    leaf_index: int = 0,
    flat_index: int = 0,
):
    """Flip ONE mantissa bit of one parameter, in place in the live model:
    the bit the reference's flipper picks for the same arguments (its
    ``leaf_index``-th leaf of the layer-stacked parameter tree, element
    ``flat_index`` of that stacked leaf).  Returns ``state``.

    The certification half of the ``sdc.flip`` seam: the trainer fires
    it host-side after the update, so the step itself is untouched and the
    corruption persists into every later step, as a real one would.
    """
    params = dict(state.model.named_parameters())
    order = _jax_order(list(params))
    name = order[leaf_index % len(order)]
    if name in params:
        layers = [params[name]]
    else:
        rest = name[len("blocks."):]
        count = sum(1 for n in params if n.startswith("blocks.")
                    and n.split(".", 2)[2] == rest)
        layers = [params[f"blocks.{i}.{rest}"] for i in range(count)]
    per_layer = layers[0].numel()
    pos = flat_index % (per_layer * len(layers))
    leaf, pos = layers[pos // per_layer], pos % per_layer
    with torch.no_grad():
        flat = leaf.view(-1)
        size = leaf.element_size()
        if size == 4:
            flat.view(torch.int32)[pos:pos + 1].bitwise_xor_(1 << (bit % 23))
        elif size == 2:
            flat.view(torch.int16)[pos:pos + 1].bitwise_xor_(1 << (bit % 7))
        else:
            byte = pos * size
            flat.view(torch.uint8)[byte:byte + 1].bitwise_xor_(
                1 << (bit % 8))
    return state
