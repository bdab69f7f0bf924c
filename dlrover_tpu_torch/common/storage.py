"""The checkpoint digest sidecar (port of two functions of
``dlrover_tpu/common/storage.py``).

The embedding plane's per-host shards carry the same ``v1`` digest as the
JAX package's, so either package restores the other's exports.
"""

from __future__ import annotations

from typing import Optional


def digest_stamp(meta_crc: int, data_crc: int, data_nbytes: int) -> str:
    """Serialize one host's checkpoint digest sidecar (crc32 of the meta
    pickle, crc32 of the raw data bytes, and the data length so plain
    truncation is caught before any crc is computed)."""
    return f"v1 meta_crc32={meta_crc} data_crc32={data_crc} " \
           f"data_nbytes={data_nbytes}"


def parse_digest(content: Optional[str]):
    """Parse a digest sidecar -> (meta_crc, data_crc, data_nbytes) or None
    (missing/unreadable digests mean "legacy checkpoint, skip verify" —
    never "reject")."""
    if not content:
        return None
    fields = {}
    parts = content.split()
    if not parts or parts[0] != "v1":
        return None
    try:
        for part in parts[1:]:
            key, _, value = part.partition("=")
            fields[key] = int(value)
        return (
            fields["meta_crc32"], fields["data_crc32"], fields["data_nbytes"]
        )
    except (KeyError, ValueError):
        return None
