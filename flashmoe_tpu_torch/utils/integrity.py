"""CRC32 content checksums (``flashmoe_tpu/utils/integrity.py``, whole).

The checkpoint manifests (:mod:`flashmoe_tpu_torch.runtime.checkpoint`)
checksum each payload file with :func:`crc32_file`; :func:`crc32_pages`
is the per-page sidecar the KV-handoff transport of the serving fabric
checksums its frames with.  Everything is :func:`zlib.crc32`: it catches
bit flips and truncation, and is an integrity check, not an authenticity
one.
"""

from __future__ import annotations

import zlib


def crc32_bytes(data: bytes, crc: int = 0) -> int:
    """CRC32 of a byte string, chainable via ``crc`` (the
    :func:`zlib.crc32` running-checksum convention)."""
    return zlib.crc32(data, crc)


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    """Chunked CRC32 of a file's content (constant memory: checkpoint
    payloads are GB-scale)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


def crc32_pages(data: bytes, pages: int) -> tuple[int, ...]:
    """Per-page CRC32 of a serialized payload: the buffer split into
    ``pages`` contiguous chunks (the last takes the remainder), each
    checksummed alone, so a receiver can name which page was corrupted."""
    pages = max(1, int(pages))
    if not data:
        return tuple(zlib.crc32(b"") for _ in range(pages))
    step = max(1, len(data) // pages)
    out = []
    for i in range(pages):
        lo = i * step
        hi = (i + 1) * step if i < pages - 1 else len(data)
        out.append(zlib.crc32(data[lo:hi]))
    return tuple(out)
