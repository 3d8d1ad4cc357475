"""Python API over the host rANS coder and the uniform bit packing of the VQ
indices (counterpart of rdeic_tpu/entropy/coder.py, for the calls the
inference path makes)."""
from __future__ import annotations

import ctypes

import numpy as np

from rdeic_torch.entropy.build import load_library


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _ptr(a: np.ndarray, ctype=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class CdfTable:
    """The quantized CDF set the coder reads."""

    def __init__(self, quantized_cdf, cdf_length, offset):
        self.cdf = _as_i32(quantized_cdf)
        self.length = _as_i32(cdf_length).reshape(-1)
        self.offset = _as_i32(offset).reshape(-1)
        if not (self.cdf.ndim == 2
                and self.cdf.shape[0] == self.length.shape[0] == self.offset.shape[0]):
            raise ValueError("cdf, length and offset disagree in size")
        self._buckets = None

    @property
    def ncdfs(self) -> int:
        return self.cdf.shape[0]

    @property
    def max_len(self) -> int:
        return self.cdf.shape[1]

    def buckets(self) -> np.ndarray:
        """Coarse cum -> symbol bucket index the decoder searches first."""
        if self._buckets is None:
            lib = load_library()
            b = np.empty(self.ncdfs * lib.rans_num_buckets(), dtype=np.uint16)
            lib.rans_build_buckets(_ptr(self.cdf), _ptr(self.length),
                                   self.ncdfs, self.max_len,
                                   _ptr(b, ctypes.c_uint16))
            self._buckets = b
        return self._buckets


class BufferedRansEncoder:
    """Collects (symbols, indexes) pairs; codes them all on flush."""

    def __init__(self):
        self._symbols: list[np.ndarray] = []
        self._indexes: list[np.ndarray] = []

    def encode_with_indexes(self, symbols, indexes) -> None:
        s = _as_i32(symbols).reshape(-1)
        i = _as_i32(indexes).reshape(-1)
        if s.shape != i.shape:
            raise ValueError("symbols/indexes length mismatch")
        self._symbols.append(s)
        self._indexes.append(i)

    def flush(self, table: CdfTable) -> bytes:
        empty = np.zeros(0, np.int32)
        symbols = np.concatenate(self._symbols) if self._symbols else empty
        indexes = np.concatenate(self._indexes) if self._indexes else empty
        self._symbols, self._indexes = [], []
        return rans_encode(symbols, indexes, table)


def rans_encode(symbols, indexes, table: CdfTable) -> bytes:
    lib = load_library()
    s = _as_i32(symbols).reshape(-1)
    i = _as_i32(indexes).reshape(-1)
    n = s.shape[0]
    capacity = max(n * 8 + 64, 1024)
    for _ in range(4):
        out = np.empty(capacity, dtype=np.uint8)
        nbytes = lib.rans_encode_with_indexes(
            _ptr(s), _ptr(i), n, _ptr(table.cdf), _ptr(table.length),
            _ptr(table.offset), table.ncdfs, table.max_len,
            _ptr(out, ctypes.c_uint8), capacity)
        if nbytes >= 0:
            return out[:nbytes].tobytes()
        if nbytes == -2:
            raise ValueError("index out of range in rans_encode")
        capacity *= 4
    raise RuntimeError("rans_encode: capacity growth failed")


class RansDecoder:
    """Persistent-stream decoder: set_stream once, decode_stream repeatedly."""

    def __init__(self):
        self._handle = None
        self._lib = load_library()

    def set_stream(self, stream: bytes) -> None:
        self.close()
        self._buf = np.ascontiguousarray(np.frombuffer(stream, dtype=np.uint8))
        self._handle = self._lib.rans_decoder_new(
            _ptr(self._buf, ctypes.c_uint8), self._buf.shape[0])

    def decode_stream(self, indexes, table: CdfTable) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("set_stream must be called first")
        i = _as_i32(indexes).reshape(-1)
        out = np.empty(i.shape[0], dtype=np.int32)
        buckets = table.buckets()
        rc = self._lib.rans_decode_stream_bucketed(
            self._handle, _ptr(i), i.shape[0], _ptr(table.cdf),
            _ptr(table.length), _ptr(table.offset), table.ncdfs,
            table.max_len, _ptr(buckets, ctypes.c_uint16), _ptr(out))
        if rc != 0:
            raise ValueError(f"rans_decode_stream failed rc={rc}")
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.rans_decoder_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def pack_uniform(indices, num_symbols: int) -> bytes:
    """Pack integer indices in [0, num_symbols) at ceil(log2 K) bits, MSB
    first."""
    bits = max(1, int(np.ceil(np.log2(num_symbols))))
    idx = np.asarray(indices).reshape(-1).astype(np.uint64)
    if idx.size and idx.max() >= num_symbols:
        raise ValueError("index out of range")
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    bitmat = ((idx[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return np.packbits(bitmat.reshape(-1)).tobytes()


def unpack_uniform(data: bytes, n: int, num_symbols: int) -> np.ndarray:
    bits = max(1, int(np.ceil(np.log2(num_symbols))))
    raw = np.unpackbits(np.frombuffer(data, dtype=np.uint8), count=n * bits)
    bitmat = raw.reshape(n, bits).astype(np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    return (bitmat << shifts[None, :]).sum(axis=1).astype(np.int32)
