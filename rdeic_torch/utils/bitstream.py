"""Bitstream container (counterpart of rdeic_tpu/utils/bitstream.py; the same
bytes): big-endian uint32 header (z-shape H, z-shape W, n_strings), then per
string a uint32 length prefix and the raw bytes."""
from __future__ import annotations

import struct
from pathlib import Path


def write_body(fd, shape, out_strings) -> int:
    """shape: (zH, zW); out_strings: list of [bytes] one-element lists."""
    header = (int(shape[0]), int(shape[1]), len(out_strings))
    fd.write(struct.pack(">3I", *header))
    count = 12
    for s in out_strings:
        fd.write(struct.pack(">I", len(s[0])))
        fd.write(s[0])
        count += 4 + len(s[0])
    return count


def read_body(fd):
    """-> (strings, shape), the inverse of write_body."""
    shape = struct.unpack(">2I", fd.read(8))
    (n_strings,) = struct.unpack(">I", fd.read(4))
    strings = []
    for _ in range(n_strings):
        (n,) = struct.unpack(">I", fd.read(4))
        strings.append([fd.read(n)])
    return strings, shape


def filesize(path) -> int:
    p = Path(path)
    if not p.is_file():
        raise ValueError(f"invalid file {path!r}")
    return p.stat().st_size
