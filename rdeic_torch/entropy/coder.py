"""Python API over the host rANS coder and the uniform bit packing of the VQ
indices (counterpart of rdeic_tpu/entropy/coder.py).

Three stream layouts, each with the same per-symbol code:
- one stream for all symbols (`rans_encode`, `RansDecoder`);
- v1 interleaved lanes: symbol j of a pass rides lane j % K, each lane an
  independent stream, back to back, with a size per lane
  (`rans_encode_interleaved`); `rdeic_torch.entropy.device_rans` decodes
  all K lanes in lock-step on the card;
- v2 shared stream: the same lanes' words merged into one stream in the
  order the lock-step decoder pulls them (`rans_encode_interleaved_shared`,
  `rans_lanes_to_shared`), read on the host by `SharedRansDecoder` or on the
  card by `device_rans.decode_pass_shared`."""
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
        self._lut = None

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

    def lut(self) -> np.ndarray:
        """cum -> symbol table, 65536 uint16 entries per CDF (the device
        decoder's symbol lookup; built by the native library so it resolves
        symbols as the host decoder does)."""
        if self._lut is None:
            lib = load_library()
            lut = np.empty(self.ncdfs * 65536, dtype=np.uint16)
            lib.rans_build_lut(_ptr(self.cdf), _ptr(self.length), self.ncdfs,
                               self.max_len, _ptr(lut, ctypes.c_uint16))
            self._lut = lut
        return self._lut


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


def _interleaved_args(symbols, indexes, pass_sizes):
    s = _as_i32(symbols).reshape(-1)
    i = _as_i32(indexes).reshape(-1)
    p = _as_i32(pass_sizes).reshape(-1)
    if s.shape != i.shape:
        raise ValueError("symbols/indexes length mismatch")
    if int(p.sum()) != s.shape[0]:
        raise ValueError("pass_sizes must sum to the symbol count")
    return s, i, p


def rans_encode_interleaved(symbols, indexes, pass_sizes, lanes: int,
                            table: CdfTable) -> tuple[bytes, np.ndarray]:
    """Stripe each pass's symbols over `lanes` independent streams (symbol
    j of a pass -> lane j % lanes). Returns (the lanes' bytes back to back,
    lane_nbytes int32 [lanes])."""
    lib = load_library()
    s, i, p = _interleaved_args(symbols, indexes, pass_sizes)
    n = s.shape[0]
    lane_nbytes = np.empty(lanes, dtype=np.int32)
    capacity = max(n * 8 + 8 * lanes + 64, 1024)
    for _ in range(4):
        out = np.empty(capacity, dtype=np.uint8)
        nbytes = lib.rans_encode_interleaved(
            _ptr(s), _ptr(i), n, _ptr(p), p.shape[0], lanes, _ptr(table.cdf),
            _ptr(table.length), _ptr(table.offset), table.ncdfs,
            table.max_len, _ptr(out, ctypes.c_uint8), capacity,
            _ptr(lane_nbytes))
        if nbytes >= 0:
            return out[:nbytes].tobytes(), lane_nbytes.copy()
        if nbytes == -2:
            raise ValueError("bad args in rans_encode_interleaved")
        capacity *= 4
    raise RuntimeError("rans_encode_interleaved: capacity growth failed")


def rans_encode_interleaved_shared(symbols, indexes, pass_sizes, lanes: int,
                                   table: CdfTable) -> bytes:
    """The v2 shared stream: the striping and code of
    `rans_encode_interleaved`, the lanes' words merged into one stream in
    the lock-step decoder's pull order (no size per lane)."""
    lib = load_library()
    s, i, p = _interleaved_args(symbols, indexes, pass_sizes)
    n = s.shape[0]
    capacity = max(n * 8 + 8 * lanes + 64, 1024)
    for _ in range(4):
        out = np.empty(capacity, dtype=np.uint8)
        nbytes = lib.rans_encode_interleaved_shared(
            _ptr(s), _ptr(i), n, _ptr(p), p.shape[0], lanes, _ptr(table.cdf),
            _ptr(table.length), _ptr(table.offset), table.ncdfs,
            table.max_len, _ptr(out, ctypes.c_uint8), capacity)
        if nbytes >= 0:
            return out[:nbytes].tobytes()
        if nbytes == -2:
            raise ValueError("bad args in rans_encode_interleaved_shared")
        if nbytes == -3:
            raise RuntimeError(
                "rans_lanes_to_shared: schedule/lane mismatch (internal)")
        capacity *= 4
    raise RuntimeError("rans_encode_interleaved_shared: capacity failed")


def rans_lanes_to_shared(lane_payload: bytes, lane_nbytes, indexes,
                         pass_sizes, table: CdfTable) -> bytes:
    """Merge v1 lane streams (from the host or the device encoder) into the
    v2 shared stream; the merge replays the decoder's pull schedule from
    the CDF indexes, so the symbols are not needed."""
    lib = load_library()
    ln = _as_i32(lane_nbytes).reshape(-1)
    i = _as_i32(indexes).reshape(-1)
    p = _as_i32(pass_sizes).reshape(-1)
    lanes = np.frombuffer(lane_payload, np.uint8)
    capacity = max(len(lane_payload) + 16, 64)
    out = np.empty(capacity, dtype=np.uint8)
    nbytes = lib.rans_lanes_to_shared(
        _ptr(lanes, ctypes.c_uint8), _ptr(ln), ln.shape[0], _ptr(i),
        i.shape[0], _ptr(p), p.shape[0], _ptr(table.cdf), _ptr(table.length),
        table.ncdfs, table.max_len, _ptr(out, ctypes.c_uint8), capacity)
    if nbytes < 0:
        raise RuntimeError(f"rans_lanes_to_shared failed: {nbytes}")
    return out[:nbytes].tobytes()


class SharedRansDecoder:
    """Host decoder of a v2 shared stream: K lane states kept across passes,
    the words pulled in the order `device_rans.decode_pass_shared` pulls
    them (and the merge wrote them)."""

    def __init__(self, stream: bytes, lanes: int):
        self._lib = load_library()
        self._buf = np.frombuffer(stream, dtype=np.uint8)  # kept alive
        self._dec = self._lib.rans_shared_decoder_new(
            _ptr(self._buf, ctypes.c_uint8), self._buf.shape[0], lanes)

    def decode_pass(self, indexes, table: CdfTable) -> np.ndarray:
        if self._dec is None:
            raise RuntimeError("decoder closed")
        i = _as_i32(indexes)
        shape = i.shape
        i = i.reshape(-1)
        out = np.empty(i.shape[0], dtype=np.int32)
        rc = self._lib.rans_shared_decode_pass(
            self._dec, _ptr(i), i.shape[0], _ptr(table.cdf),
            _ptr(table.length), _ptr(table.offset), table.ncdfs,
            table.max_len, _ptr(out))
        if rc != 0:
            raise ValueError(f"rans_shared_decode_pass failed: {rc}")
        return out.reshape(shape)

    def close(self) -> None:
        if self._dec is not None:
            self._lib.rans_shared_decoder_free(self._dec)
            self._dec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
