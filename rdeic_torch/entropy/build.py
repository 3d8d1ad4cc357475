"""Loads the host rANS library (built by rdeic_torch.build) and declares the
ctypes signatures of the calls the codec makes: the single-stream
route, and the interleaved-lane and shared-stream routes."""
from __future__ import annotations

import ctypes
import functools

from rdeic_torch.build import build_rans


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_rans()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i = ctypes.c_int
    lib.rans_encode_with_indexes.restype = i
    lib.rans_encode_with_indexes.argtypes = [
        i32p, i32p, i, i32p, i32p, i32p, i, i, u8p, i]
    lib.rans_decoder_new.restype = ctypes.c_void_p
    lib.rans_decoder_new.argtypes = [u8p, i]
    lib.rans_decoder_free.restype = None
    lib.rans_decoder_free.argtypes = [ctypes.c_void_p]
    lib.rans_num_buckets.restype = i
    lib.rans_num_buckets.argtypes = []
    lib.rans_build_buckets.restype = None
    lib.rans_build_buckets.argtypes = [i32p, i32p, i, i, u16p]
    lib.rans_decode_stream_bucketed.restype = i
    lib.rans_decode_stream_bucketed.argtypes = [
        ctypes.c_void_p, i32p, i, i32p, i32p, i32p, i, i, u16p, i32p]
    lib.rans_build_lut.restype = None
    lib.rans_build_lut.argtypes = [i32p, i32p, i, i, u16p]
    # the interleaved-lane (v1) and shared-stream (v2) routes
    lib.rans_encode_interleaved.restype = i
    lib.rans_encode_interleaved.argtypes = [
        i32p, i32p, i, i32p, i, i, i32p, i32p, i32p, i, i, u8p, i, i32p]
    lib.rans_encode_interleaved_shared.restype = i
    lib.rans_encode_interleaved_shared.argtypes = [
        i32p, i32p, i, i32p, i, i, i32p, i32p, i32p, i, i, u8p, i]
    lib.rans_lanes_to_shared.restype = i
    lib.rans_lanes_to_shared.argtypes = [
        u8p, i32p, i, i32p, i, i32p, i, i32p, i32p, i, i, u8p, i]
    lib.rans_shared_decoder_new.restype = ctypes.c_void_p
    lib.rans_shared_decoder_new.argtypes = [u8p, i, i]
    lib.rans_shared_decoder_free.restype = None
    lib.rans_shared_decoder_free.argtypes = [ctypes.c_void_p]
    lib.rans_shared_decode_pass.restype = i
    lib.rans_shared_decode_pass.argtypes = [
        ctypes.c_void_p, i32p, i, i32p, i32p, i32p, i, i, i32p]
    return lib
