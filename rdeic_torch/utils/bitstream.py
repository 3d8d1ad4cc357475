"""Bitstream container (counterpart of rdeic_tpu/utils/bitstream.py; the same
bytes): big-endian uint32 header (z-shape H, z-shape W, n_strings), then per
string a uint32 length prefix and the raw bytes."""
from __future__ import annotations

import struct
from pathlib import Path


def write_uints(fd, values) -> int:
    fd.write(struct.pack(f">{len(values)}I", *values))
    return len(values) * 4


def read_uints(fd, n) -> tuple:
    return struct.unpack(f">{n}I", fd.read(n * 4))


def write_bytes(fd, values) -> int:
    if len(values) == 0:
        return 0
    fd.write(values)
    return len(values)


def read_bytes(fd, n) -> bytes:
    return fd.read(n)


def write_body(fd, shape, out_strings) -> int:
    """shape: (zH, zW); out_strings: list of [bytes] one-element lists."""
    cnt = write_uints(fd, (int(shape[0]), int(shape[1]), len(out_strings)))
    for s in out_strings:
        cnt += write_uints(fd, (len(s[0]),))
        cnt += write_bytes(fd, s[0])
    return cnt


def read_body(fd):
    """-> (strings, shape), the inverse of write_body."""
    strings = []
    shape = read_uints(fd, 2)
    (n_strings,) = read_uints(fd, 1)
    for _ in range(n_strings):
        (n,) = read_uints(fd, 1)
        strings.append([read_bytes(fd, n)])
    return strings, shape


def filesize(path) -> int:
    p = Path(path)
    if not p.is_file():
        raise ValueError(f"invalid file {path!r}")
    return p.stat().st_size
