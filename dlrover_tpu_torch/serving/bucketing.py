"""Prompt-length bucketing for prefill (port of
``dlrover_tpu/serving/bucketing.py``).

Padding every prompt up to one of a small fixed set of bucket widths caps
the distinct prefill shapes at ``len(buckets)``, which keeps the JAX
package's programs compiled once per bucket and gives the port the same
admission rule and the same per-bucket prefill cost to measure.

The pad region is causally inert by construction: pad tokens sit at
positions ``[true_len, bucket)``, causal masking keeps them out of every
real token's prefill attention, and each decode step at position ``p``
overwrites the pad K/V at ``p`` before the attention mask (``kpos <= p``)
can reach it, so right-padding needs no scrubbing pass.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def make_buckets(
    max_len: int, start: int = 16, factor: int = 2
) -> Tuple[int, ...]:
    """Geometric bucket widths ``start, start*factor, ... <= max_len``.

    The last bucket is clamped to ``max_len`` so the full prompt range is
    admissible.  ``factor=2`` bounds pad waste at <50% per prompt while
    keeping the compiled-program count logarithmic in ``max_len``.
    """
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if start < 1 or factor < 2:
        raise ValueError(
            f"start must be >= 1 and factor >= 2, got {start}/{factor}"
        )
    out = []
    width = min(start, max_len)
    while width < max_len:
        out.append(width)
        width *= factor
    out.append(max_len)
    return tuple(out)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket admitting ``length``; raises when none does (an
    oversize prompt must be rejected at admission, not silently truncated).
    """
    if not buckets:
        raise ValueError("no buckets configured")
    if length < 1:
        raise ValueError(f"prompt length must be >= 1, got {length}")
    for width in sorted(buckets):
        if length <= width:
            return width
    raise ValueError(
        f"prompt length {length} exceeds the largest bucket "
        f"{max(buckets)}"
    )


def pad_to_bucket(
    prompt: np.ndarray, buckets: Sequence[int], pad_id: int = 0
) -> Tuple[np.ndarray, int]:
    """Right-pad a 1-D or 2-D int token array to its bucket width.

    Returns ``(padded, true_len)`` where ``true_len`` is the original
    width.  2-D inputs share one width (lockstep RL rollouts); per-request
    ragged batching is the serving engine's job, which pads row by row.
    """
    arr = np.asarray(prompt)
    true_len = arr.shape[-1]
    width = pick_bucket(true_len, buckets)
    if width == true_len:
        return arr, true_len
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, width - true_len)]
    return np.pad(arr, pad, constant_values=pad_id), true_len
