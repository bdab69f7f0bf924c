"""Train-state digest for silent-data-corruption detection (port of
``dlrover_tpu/trainer/state_digest.py``).

Every replica of one train state holds the same bits, so one uint32 per
replica turns that invariant into a vote (the master's digest ledger,
ROADMAP Queue 1 item 9).  Construction, as in the reference: each leaf's
raw bytes are summed (mod 2^32), then folded into a running accumulator
with an odd multiplier, ``acc = acc * 1000003 + leaf_sum`` (mod 2^32).
The multiplier is invertible mod 2^32, so one flipped bit anywhere
changes the digest.  This is a corruption detector, not a hash.

The reference's digest is a jitted reduction, not a Pallas kernel; here
it is PyTorch ops on the leaves' device, and no host sync: the value
stays a 0-d int64 tensor until a report formats it.  The uint32
arithmetic runs in int64 under a mask.

Temporaries: ``sum`` of a uint8 byte view with a wider accumulator
casts its input first (an int64 sum of 200 MB of bytes took 1.6 GB more
on the CPU), and a byte view of the 3.37 GB GPT-2 1.5B train state
widened to int64 would be about 27 GB.  So a leaf longer than
``ROW_BYTES`` (8 MiB: a row's int32 sum is exact, 2^23 * 255 < 2^31) is
summed in rows, ``GROUP_ROWS`` rows a launch (128 MiB of bytes widened to
512 MiB), and the row sums in int64; a shorter one in int64 at once.  The fold is vectorised: with ``p_i = M^(n-1-i)``
mod 2^32, ``acc = sum_i s_i p_i`` mod 2^32, each product split at 16 bits
of ``p_i`` so it stays below 2^49.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint import shm_handler

MULTIPLIER = 1000003
MASK = 0xFFFFFFFF
ROW_BYTES = 1 << 23
GROUP_ROWS = 16

_POWERS: Dict[Tuple[int, str], torch.Tensor] = {}


def leaf_sum(leaf: Any, device: torch.device) -> torch.Tensor:
    """Byte sum of one leaf's raw bits as a 0-d int64 tensor on
    ``device`` (not yet reduced mod 2^32).  A Python int is the JAX
    package's int32 step counter."""
    if not isinstance(leaf, torch.Tensor):
        if not isinstance(leaf, int):
            raise TypeError(f"cannot digest a {type(leaf).__name__} leaf")
        total = int(np.asarray(leaf, np.int32).reshape(1).view(np.uint8)
                    .sum(dtype=np.int64))
        return torch.full((), total, dtype=torch.int64, device=device)
    t = leaf.detach()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    flat = t.reshape(-1).contiguous().view(torch.uint8)
    if flat.numel() <= ROW_BYTES:
        return flat.sum(dtype=torch.int64)
    rows = flat.numel() // ROW_BYTES
    tail = flat[rows * ROW_BYTES:].sum(dtype=torch.int64)
    body = flat[:rows * ROW_BYTES].view(rows, ROW_BYTES)
    parts = [group.sum(dim=1, dtype=torch.int32).sum(dtype=torch.int64)
             for group in body.split(GROUP_ROWS)]
    return torch.stack(parts + [tail]).sum()


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


def digest_leaves(leaves: Sequence[Any]) -> torch.Tensor:
    """Order-sensitive fold of ``leaves`` into one uint32, as a 0-d int64
    tensor on their device (the reference's ``_digest_tree`` of the same
    leaves, bit for bit)."""
    device = _device_of(leaves)
    if not leaves:
        return torch.zeros((), dtype=torch.int64, device=device)
    sums = torch.stack([leaf_sum(leaf, device) for leaf in leaves])
    s = sums & MASK
    powers = _powers(len(leaves), device)
    hi, lo = powers >> 16, powers & 0xFFFF
    terms = ((((s * hi) & 0xFFFF) << 16) + s * lo) & MASK
    return terms.sum() & MASK


def digest_state(state) -> torch.Tensor:
    """The digest of a ``train_lib.TrainState``: its step counter, then
    what Flash Checkpoint saves of it (parameters and optimizer state)."""
    return digest_leaves([state.step] + [
        leaf for _, leaf in
        shm_handler.tree_flatten_with_path(state.checkpoint_tree())])


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
