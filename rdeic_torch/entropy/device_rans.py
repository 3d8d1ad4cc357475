"""Interleaved-lane rANS on the card: decode and encode over [batch, lanes]
(counterpart of rdeic_tpu/entropy/device_rans.py).

The host encoder (`coder.rans_encode_interleaved`) stripes each pass's
symbols over K independent rANS lanes, symbol j of a pass on lane j % K. A
decoder can then resolve K symbols a step in lock-step, and the codec's
decode chain keeps every pass's symbols on the card: no host round trip
between the entropy-parameter passes. Two containers:
- v1: K lane streams, each with its own words (`decode_pass`);
- v2: one word stream per image, the lanes' words merged in the order the
  lock-step decoder pulls them (`decode_pass_shared`): at each pull phase a
  lane's word sits at the image's cursor plus the count of lower-numbered
  lanes pulling in that phase.
`encode_lanes` is the mirror of `decode_pass`: every pass's symbols onto
[B, K] lanes on the card, so only the lanes' words cross to the host.

Three functions have a hand-written CUDA kernel (`rdeic_torch/csrc/
device_rans.cu`) and a plain PyTorch version beside it: `decode_pass`,
`decode_pass_shared` and `encode_lanes`. A CUDA tensor launches the kernel
(one launch a call, counted in the wrapper's `launches`); a CPU tensor takes
the plain version, which follows the JAX functions step by step. The rest is
host NumPy or small tensor code, as in the JAX package: `lanes_from_bytes`,
`shared_words_from_bytes`, `assemble_lane_payloads` and `pad_pass_indexes`
on the host, `init_lane_state`, `init_shared_state` and `build_pass_steps`
in torch on the tensors' device.

Bit-exactness: the per-symbol code (16-bit probabilities and renorm words,
an escape slot then 4-bit bypass chunks) is the host coder's, and every
table and word gather clamps its index as the JAX `take(mode="clip")` does,
so a corrupt stream decodes to the same garbage on both sides and never
reads out of bounds. The decoder pulls at most one word per renorm, which is
the host loop on every well-formed stream.

Layouts (the JAX package's, in torch dtypes): words int32 holding 16-bit
values, nwords and ptr int32, the rANS state int64 holding the uint32 value,
CDF indexes and symbols int32. Escape payloads keep the JAX int32 arithmetic
(a chunk shifted past bit 31 wraps), so corrupt streams give the JAX
package's symbols too.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rdeic_torch import build

_PROB_BITS = 16
_RANS_L = 1 << 16
_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF
MAX_SHARED_LANES = 1024  # one CTA per image: a thread per lane


class DeviceRansTables:
    """The CDF tables on `device`: the flat quantized CDF, lengths, offsets
    and the cum -> symbol LUT (64 CDFs x 65536 uint16, 8 MiB; built by the
    native library, so it resolves symbols as the host decoder does)."""

    def __init__(self, table, device="cpu"):
        device = torch.device(device)
        self.ncdfs = table.ncdfs
        self.max_len = table.max_len
        self.cdf_flat = torch.from_numpy(table.cdf.reshape(-1).copy()).to(device)
        self.lengths = torch.from_numpy(table.length.copy()).to(device)
        self.offsets = torch.from_numpy(table.offset.copy()).to(device)
        # uint16 entries, stored as their int16 bit patterns
        self.lut_flat = torch.from_numpy(
            table.lut().view(np.int16).copy()).to(device)

    @property
    def device(self) -> torch.device:
        return self.cdf_flat.device

    def lut_values(self) -> torch.Tensor:
        """The LUT as int64 symbols (the plain versions' view)."""
        return self.lut_flat.long() & _MASK16


# -- host helpers ---------------------------------------------------------------
def lanes_from_bytes(payload: bytes, lane_nbytes):
    """v1 lane bytes back to back -> (words [K, W] uint32, each entry one
    little-endian 16-bit word, and nwords [K] int32)."""
    lane_nbytes = np.asarray(lane_nbytes, np.int64)
    k = lane_nbytes.shape[0]
    nwords = (lane_nbytes // 2).astype(np.int32)
    wmax = int(nwords.max()) if k else 0
    words = np.zeros((k, max(wmax, 2)), np.uint32)
    pos = 0
    for i in range(k):
        nb = int(lane_nbytes[i])
        lane = np.frombuffer(payload, np.uint8, nb, pos).astype(np.uint32)
        pos += nb
        w = lane[0::2] | (lane[1::2] << 8)
        words[i, :w.shape[0]] = w
    return words, nwords


def shared_words_from_bytes(payload: bytes):
    """v2 shared-stream bytes -> (words [W] uint32 16-bit words, count)."""
    arr = np.frombuffer(payload, np.uint8)
    n = arr.shape[0] // 2
    a = arr[:n * 2].astype(np.uint32)
    return a[0::2] | (a[1::2] << 8), n


def assemble_lane_payloads(words_np: np.ndarray, nwords_np: np.ndarray):
    """[K, W] emit-order words + [K] counts (one image of `encode_lanes`)
    -> (payload bytes, lane_nbytes int32 [K]) in `rans_encode_interleaved`'s
    layout: per lane, its words reversed, each little-endian."""
    knum, wmax = words_np.shape
    nw = nwords_np.astype(np.int64)
    ar = np.arange(wmax, dtype=np.int64)
    src = nw[:, None] - 1 - ar[None, :]
    rev = np.take_along_axis(
        words_np, np.clip(src, 0, max(wmax - 1, 0)), axis=1).astype(np.uint16)
    le = np.empty((knum, wmax, 2), np.uint8)
    le[..., 0] = rev & 0xFF
    le[..., 1] = rev >> 8
    flat = le.reshape(knum, wmax * 2)
    lane_nbytes = (nw * 2).astype(np.int32)
    payload = b"".join(flat[i, :lane_nbytes[i]].tobytes() for i in range(knum))
    return payload, lane_nbytes


def pad_pass_indexes(idx_flat: np.ndarray, k: int):
    """Pad a pass's flat index vector to a multiple of K lanes with zeros;
    returns (padded, the pass's symbol count)."""
    n = idx_flat.shape[-1]
    pad = -(-n // k) * k - n
    if pad:
        idx_flat = np.concatenate(
            [idx_flat, np.zeros((*idx_flat.shape[:-1], pad), idx_flat.dtype)],
            axis=-1)
    return idx_flat, n


# -- state -------------------------------------------------------------------------
def init_lane_state(words: torch.Tensor, nwords: torch.Tensor):
    """v1: each lane's state from its first two words (high, then low), as
    the host decoder's init; a lane too short for them starts at 0. words
    [..., K, W], nwords [..., K] -> (state int64, ptr int32), [..., K]."""
    state = (words[..., 0].long() << 16) | words[..., 1].long()
    state = torch.where(nwords >= 2, state, torch.zeros_like(state))
    return state, torch.full(state.shape, 2, dtype=torch.int32,
                             device=words.device)


def init_shared_state(words: torch.Tensor, nwords: torch.Tensor, k: int):
    """v2: lane j's state from words 2j (high) and 2j + 1 (low) of its
    image's stream, words past the stream's end reading 0. words [..., W],
    nwords [...] -> (state [..., K] int64, ptr [...] int32 = 2K)."""
    head = torch.zeros((*words.shape[:-1], 2 * k), dtype=torch.int64,
                       device=words.device)
    m = min(2 * k, words.shape[-1])
    head[..., :m] = words[..., :m].long()
    avail = torch.arange(2 * k, device=words.device) < nwords[..., None].long()
    head = torch.where(avail, head, torch.zeros_like(head))
    state = (head[..., 0::2] << 16) | head[..., 1::2]
    return state, torch.full(nwords.shape, 2 * k, dtype=torch.int32,
                             device=words.device)


def build_pass_steps(syms, idxs, k: int):
    """Per-pass [B, ...] symbol and index tensors -> step-major [T, B, K]
    (symbols, indexes, valid), each pass padded to a multiple of K with
    invalid zeros, so symbol j of a pass rides lane j % K as in
    `rans_encode_interleaved`."""
    sym_steps, idx_steps, valid_steps = [], [], []
    b = syms[0].shape[0]
    for s, ix in zip(syms, idxs):
        n = s[0].numel()
        s = s.reshape(b, n).to(torch.int32)
        ix = ix.reshape(b, n).to(torch.int32)
        pad = (-n) % k
        if pad:
            s = torch.nn.functional.pad(s, (0, pad))
            ix = torch.nn.functional.pad(ix, (0, pad))
        t = (n + pad) // k
        sym_steps.append(s.reshape(b, t, k).transpose(0, 1))
        idx_steps.append(ix.reshape(b, t, k).transpose(0, 1))
        valid = (torch.arange(t * k, device=s.device) < n).reshape(t, 1, k)
        valid_steps.append(valid.expand(t, b, k))
    return (torch.cat(sym_steps).contiguous(), torch.cat(idx_steps).contiguous(),
            torch.cat(valid_steps).contiguous())


# -- plain versions (CPU tensors) --------------------------------------------------
def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[idx] with the index clamped into range (JAX mode="clip")."""
    return flat[idx.clamp(0, flat.numel() - 1)]


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values to int32's range, as int32 arithmetic does."""
    return ((x + (1 << 31)) & _MASK32) - (1 << 31)


def _unzigzag(z: torch.Tensor, max_value: torch.Tensor) -> torch.Tensor:
    """The escape value of bypass payload z (its 32 bits read as int32, as
    the JAX package's int32 z is)."""
    zs = _i32(z & _MASK32)
    return torch.where((zs & 1) != 0, -(zs >> 1) - 1, (zs >> 1) + max_value)


def _symbol_step(tab, lut, state, cdf_idx):
    """One lock-step symbol resolution: (s, the advanced state before its
    renorm, max_value, offset)."""
    cum = state & _MASK16
    s = _take(lut, _i32((cdf_idx << _PROB_BITS) | cum))
    base = _i32(cdf_idx * tab.max_len)
    lo = _take(tab.cdf_flat, _i32(base + s)).long()
    hi = _take(tab.cdf_flat, _i32(base + s + 1)).long()
    adv = ((hi - lo) * (state >> _PROB_BITS) + cum - lo) & _MASK32
    max_value = _take(tab.lengths, cdf_idx).long() - 2
    return s, adv, max_value, _take(tab.offsets, cdf_idx).long()


def _check_plain(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(f"the plain version takes CPU tensors, got {t.device}")


def decode_pass_plain(tables: DeviceRansTables, words, nwords, state, ptr,
                      idx, n_valid: int):
    """`decode_pass` in plain PyTorch on CPU tensors (the JAX scan, step by
    step)."""
    _check_plain(words, nwords, state, ptr, idx, tables.cdf_flat)
    *batch, k, w = words.shape
    t_steps = idx.shape[-1] // k
    if t_steps * k != idx.shape[-1]:
        raise ValueError("idx must hold a multiple of K entries")
    lut = tables.lut_values()
    words_flat = words.reshape(-1).long()
    nb = int(np.prod(batch, dtype=np.int64))
    lane_base = (torch.arange(nb * k, dtype=torch.int64) * w).reshape(*batch, k)
    nw = nwords.long()
    idx_steps = idx.long().reshape(*batch, t_steps, k)
    state, ptr = state.long().clone(), ptr.long().clone()

    def renorm(st, pt):
        pull = (st < _RANS_L) & (pt < nw)
        wd = _take(words_flat, lane_base + pt)
        return torch.where(pull, ((st << 16) | wd) & _MASK32, st), pt + pull.long()

    syms = torch.zeros((*batch, t_steps, k), dtype=torch.int64)
    lane = torch.arange(k)
    for t in range(t_steps):
        cdf_idx = idx_steps[..., t, :]
        valid = (t * k + lane) < n_valid
        s, adv, max_value, offset = _symbol_step(tables, lut, state, cdf_idx)
        new_state, new_ptr = renorm(adv, ptr)
        esc = valid & (s == max_value)
        z = torch.zeros_like(s)
        shift = torch.zeros_like(s)
        active = esc
        while bool(active.any()):
            bits = new_state & 0xF
            st2, pt2 = renorm(new_state >> 4, new_ptr)
            z = torch.where(active, (z | ((bits & 7) << shift)) & _MASK32, z)
            shift2 = torch.where(active, shift + 3, shift)
            new_state = torch.where(active, st2, new_state)
            new_ptr = torch.where(active, pt2, new_ptr)
            active = active & ((bits & 8) != 0) & (shift2 <= 30)
            shift = shift2
        v = torch.where(esc, _unzigzag(z, max_value), s)
        syms[..., t, :] = torch.where(valid, _i32(v + offset), 0)
        state = torch.where(valid, new_state, state)
        ptr = torch.where(valid, new_ptr, ptr)
    return (syms.reshape(*batch, t_steps * k).to(torch.int32),
            (state, ptr.to(torch.int32)))


def _pull_many(words_flat, img_base, nwords, st, pt, pull):
    """Pull one word for each flagged lane, lane-major: a lane's word is at
    the cursor plus the count of lower lanes pulling (an exclusive cumsum);
    past the stream's end reads 0; the cursor moves by the count."""
    pc = pull.long()
    offs = torch.cumsum(pc, dim=-1) - pc
    pos = pt[..., None] + offs
    wd = _take(words_flat, img_base[..., None] + pos)
    wd = torch.where(pos < nwords[..., None], wd, torch.zeros_like(wd))
    st = torch.where(pull, ((st << 16) | wd) & _MASK32, st)
    return st, pt + pc.sum(dim=-1)


def decode_pass_shared_plain(tables: DeviceRansTables, words, nwords, state,
                             ptr, idx, n_valid: int):
    """`decode_pass_shared` in plain PyTorch on CPU tensors."""
    _check_plain(words, nwords, state, ptr, idx, tables.cdf_flat)
    *batch, w_len = words.shape
    k = state.shape[-1]
    t_steps = idx.shape[-1] // k
    if t_steps * k != idx.shape[-1]:
        raise ValueError("idx must hold a multiple of K entries")
    lut = tables.lut_values()
    words_flat = words.reshape(-1).long()
    nb = int(np.prod(batch, dtype=np.int64))
    img_base = (torch.arange(nb, dtype=torch.int64) * w_len).reshape(*batch)
    nw = nwords.long()
    idx_steps = idx.long().reshape(*batch, t_steps, k)
    state, ptr = state.long().clone(), ptr.long().clone()
    syms = torch.zeros((*batch, t_steps, k), dtype=torch.int64)
    lane = torch.arange(k)
    for t in range(t_steps):
        cdf_idx = idx_steps[..., t, :]
        valid = ((t * k + lane) < n_valid).expand_as(cdf_idx)
        s, adv, max_value, offset = _symbol_step(tables, lut, state, cdf_idx)
        state = torch.where(valid, adv, state)
        state, ptr = _pull_many(words_flat, img_base, nw, state, ptr,
                                valid & (state < _RANS_L))
        esc = valid & (s == max_value)
        z = torch.zeros_like(s)
        shift = torch.zeros_like(s)
        active = esc
        while bool(active.any()):
            bits = state & 0xF
            state = torch.where(active, state >> 4, state)
            state, ptr = _pull_many(words_flat, img_base, nw, state, ptr,
                                    active & (state < _RANS_L))
            z = torch.where(active, (z | ((bits & 7) << shift)) & _MASK32, z)
            shift2 = torch.where(active, shift + 3, shift)
            active = active & ((bits & 8) != 0) & (shift2 <= 30)
            shift = shift2
        v = torch.where(esc, _unzigzag(z, max_value), s)
        syms[..., t, :] = torch.where(valid, _i32(v + offset), 0)
    return (syms.reshape(*batch, t_steps * k).to(torch.int32),
            (state, ptr.to(torch.int32)))


def encode_lanes_plain(tables: DeviceRansTables, sym_steps, idx_steps,
                       valid_steps, wcap: int):
    """`encode_lanes` in plain PyTorch on CPU tensors (the JAX precompute,
    then the reverse scan of six bypass stages and the slot code)."""
    _check_plain(sym_steps, idx_steps, valid_steps, tables.cdf_flat)
    t_tot, b, k = sym_steps.shape
    cidx = idx_steps.long()
    valid = valid_steps.bool()
    max_value = _take(tables.lengths, cidx).long() - 2
    v = _i32(sym_steps.long() - _take(tables.offsets, cidx).long())
    esc = valid & ((v < 0) | (v >= max_value))
    slot = torch.where(esc, max_value,
                       torch.minimum(v.clamp(min=0), max_value - 1))
    base = _i32(cidx * tables.max_len)
    lo = _take(tables.cdf_flat, _i32(base + slot)).long()
    hi = _take(tables.cdf_flat, _i32(base + slot + 1)).long()
    start = lo & _MASK16
    freq = ((hi - lo - 1) & _MASK16) + 1
    z = torch.where(v >= max_value, _i32((v - max_value) << 1),
                    _i32(((-v - 1) << 1) | 1)) & _MASK32
    z = torch.where(esc, z, torch.zeros_like(z))
    ovf = bool(((z >> 18) != 0).any())
    shift0 = torch.zeros_like(z)
    for s in range(3, 18, 3):
        shift0 = torch.where((z >> s) != 0, s, shift0)

    words = torch.zeros(b * k * wcap, dtype=torch.int64)
    lane_base = (torch.arange(b * k, dtype=torch.int64) * wcap).reshape(b, k)
    x = torch.full((b, k), _RANS_L, dtype=torch.int64)
    wptr = torch.zeros((b, k), dtype=torch.int64)

    def emit(pos_ok, pos, w16):
        """Scatter w16 at lane offsets `pos` where pos_ok and pos < wcap."""
        keep = pos_ok & (pos < wcap)
        words[(lane_base + pos)[keep]] = w16[keep]

    for t in range(t_tot - 1, -1, -1):
        e, sh0, zt = esc[t], shift0[t], z[t]
        ce = torch.zeros_like(wptr)
        w_c0 = torch.zeros_like(wptr)
        w_c1 = torch.zeros_like(wptr)
        for j in range(6):
            active = e & (sh0 >= 3 * j)
            sh = torch.where(active, sh0 - 3 * j, 0)
            bits = ((zt >> sh) & 7) | (8 if j else 0)
            em = active & (x >= (1 << 28))
            w16 = x & _MASK16
            w_c0 = torch.where(em & (ce == 0), w16, w_c0)
            w_c1 = torch.where(em & (ce == 1), w16, w_c1)
            ce = ce + em.long()
            x1 = torch.where(em, x >> 16, x)
            x = torch.where(active, ((x1 << 4) | bits) & _MASK32, x)
        vt, fq = valid[t], freq[t]
        em_s = vt & ((x >> 16) >= fq)
        w_s = x & _MASK16
        x1 = torch.where(em_s, x >> 16, x)
        q = x1 // fq
        x = torch.where(vt, ((q << _PROB_BITS) + (x1 - q * fq) + start[t])
                        & _MASK32, x)
        emit(ce >= 1, wptr, w_c0)
        emit(ce >= 2, wptr + 1, w_c1)
        emit(em_s, wptr + ce, w_s)
        wptr = wptr + ce + em_s.long()
    everyone = torch.ones_like(wptr, dtype=torch.bool)
    emit(everyone, wptr, x & _MASK16)  # flush: low word, then high word
    emit(everyone, wptr + 1, x >> 16)
    nwords = wptr + 2
    ovf = ovf or bool((nwords > wcap).any())
    return (words.reshape(b, k, wcap).to(torch.int32), nwords.to(torch.int32),
            torch.tensor(ovf))


# -- the kernels' wrappers ---------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_device_rans()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rdeic_rans_decode_lanes.restype = i
    lib.rdeic_rans_decode_lanes.argtypes = [vp] * 12 + [i] * 7 + [vp]
    lib.rdeic_rans_decode_shared.restype = i
    lib.rdeic_rans_decode_shared.argtypes = [vp] * 12 + [i] * 7 + [vp]
    lib.rdeic_rans_encode_lanes.restype = i
    lib.rdeic_rans_encode_lanes.argtypes = [vp] * 9 + [i] * 6 + [vp]
    lib.rdeic_rans_error_string.restype = ctypes.c_char_p
    lib.rdeic_rans_error_string.argtypes = [i]
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = (_library().rdeic_rans_error_string(err).decode() if err > 0
               else "unsupported arguments")
        raise RuntimeError(f"{name} launch failed: {msg}")


def _tally(name: str, key) -> None:
    """One launch of wrapper `name`, tallied on the wrapper itself (held
    from import, so a spy put in its place counts nothing twice)."""
    fn = _WRAPPERS[name]
    fn.launches += 1
    fn.shapes[key] = fn.shapes.get(key, 0) + 1


def _check_cuda(name: str, tables: DeviceRansTables, *tensors) -> int:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in (*tensors, tables.cdf_flat):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors on {dev}, "
                             f"with the tables there too")
    return dev.index


def _stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


def _dtypes(name, **want) -> None:
    for arg, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")


def decode_pass(tables: DeviceRansTables, words, nwords, state, ptr, idx,
                n_valid: int):
    """Decode one pass of v1 lanes. words [B, K, W], nwords [B, K], state
    and ptr [B, K], idx [B, T*K] (the pass's CDF indexes, zeros past
    n_valid). Returns (symbols [B, T*K] int32, zero past n_valid, and the
    advanced (state, ptr)). CUDA tensors launch `rans_decode_lanes` once."""
    if words.device.type == "cpu":
        return decode_pass_plain(tables, words, nwords, state, ptr, idx, n_valid)
    index = _check_cuda("decode_pass", tables, words, nwords, state, ptr, idx)
    _dtypes("decode_pass", words=(words, torch.int32),
            nwords=(nwords, torch.int32), state=(state, torch.int64),
            ptr=(ptr, torch.int32), idx=(idx, torch.int32))
    b, k, w = words.shape
    t_steps = idx.shape[-1] // k
    if (idx.shape != (b, t_steps * k) or nwords.shape != (b, k)
            or state.shape != (b, k) or ptr.shape != (b, k)):
        raise ValueError("decode_pass: shapes disagree")
    if b * k * w >= 2 ** 31 or idx.numel() >= 2 ** 31:
        raise ValueError("decode_pass takes fewer than 2^31 words and indexes")
    syms = torch.empty_like(idx)
    state_out, ptr_out = torch.empty_like(state), torch.empty_like(ptr)
    err = _library().rdeic_rans_decode_lanes(
        words.data_ptr(), nwords.data_ptr(), state.data_ptr(), ptr.data_ptr(),
        idx.data_ptr(), tables.lut_flat.data_ptr(), tables.cdf_flat.data_ptr(),
        tables.lengths.data_ptr(), tables.offsets.data_ptr(),
        syms.data_ptr(), state_out.data_ptr(), ptr_out.data_ptr(), b, k, w,
        t_steps, n_valid, tables.max_len, tables.ncdfs, _stream(index))
    _raise_on(err, "rans_decode_lanes")
    _tally("decode_pass", (b, k, t_steps))
    return syms, (state_out, ptr_out)


def decode_pass_shared(tables: DeviceRansTables, words, nwords, state, ptr,
                       idx, n_valid: int):
    """Decode one pass of v2 shared streams. words [B, W], nwords [B], state
    [B, K], ptr [B] (one cursor per image), idx as `decode_pass`. CUDA
    tensors launch `rans_decode_shared` once (K <= 1024)."""
    if words.device.type == "cpu":
        return decode_pass_shared_plain(tables, words, nwords, state, ptr,
                                        idx, n_valid)
    index = _check_cuda("decode_pass_shared", tables, words, nwords, state,
                        ptr, idx)
    _dtypes("decode_pass_shared", words=(words, torch.int32),
            nwords=(nwords, torch.int32), state=(state, torch.int64),
            ptr=(ptr, torch.int32), idx=(idx, torch.int32))
    b, w = words.shape
    k = state.shape[-1]
    t_steps = idx.shape[-1] // k
    if (idx.shape != (b, t_steps * k) or nwords.shape != (b,)
            or state.shape != (b, k) or ptr.shape != (b,)):
        raise ValueError("decode_pass_shared: shapes disagree")
    if k > MAX_SHARED_LANES:
        raise ValueError(f"decode_pass_shared takes at most "
                         f"{MAX_SHARED_LANES} lanes, got {k}")
    if b * w >= 2 ** 31 or idx.numel() >= 2 ** 31:
        raise ValueError("decode_pass_shared takes fewer than 2^31 words")
    syms = torch.empty_like(idx)
    state_out, ptr_out = torch.empty_like(state), torch.empty_like(ptr)
    err = _library().rdeic_rans_decode_shared(
        words.data_ptr(), nwords.data_ptr(), state.data_ptr(), ptr.data_ptr(),
        idx.data_ptr(), tables.lut_flat.data_ptr(), tables.cdf_flat.data_ptr(),
        tables.lengths.data_ptr(), tables.offsets.data_ptr(),
        syms.data_ptr(), state_out.data_ptr(), ptr_out.data_ptr(), b, k, w,
        t_steps, n_valid, tables.max_len, tables.ncdfs, _stream(index))
    _raise_on(err, "rans_decode_shared")
    _tally("decode_pass_shared", (b, k, t_steps))
    return syms, (state_out, ptr_out)


def encode_lanes(tables: DeviceRansTables, sym_steps, idx_steps, valid_steps,
                 wcap: int):
    """Encode every pass's symbols onto [B, K] lanes. sym / idx / valid
    [T, B, K] (int32 / int32 / bool) in forward stream order
    (`build_pass_steps`). Returns (words [B, K, wcap] int32 16-bit words in
    emit order, the stream order reversed: see `assemble_lane_payloads`;
    nwords [B, K] int32 with the 2-word state flush; overflow, a bool
    scalar tensor: set when a lane needs more than wcap words or an escape
    payload reaches 2^18, and then the words are unusable). CUDA tensors
    launch `rans_encode_lanes` once."""
    if sym_steps.device.type == "cpu":
        return encode_lanes_plain(tables, sym_steps, idx_steps, valid_steps,
                                  wcap)
    index = _check_cuda("encode_lanes", tables, sym_steps, idx_steps,
                        valid_steps)
    _dtypes("encode_lanes", sym_steps=(sym_steps, torch.int32),
            idx_steps=(idx_steps, torch.int32),
            valid_steps=(valid_steps, torch.bool))
    t_tot, b, k = sym_steps.shape
    if idx_steps.shape != sym_steps.shape or valid_steps.shape != sym_steps.shape:
        raise ValueError("encode_lanes: shapes disagree")
    if b * k * wcap >= 2 ** 31 or sym_steps.numel() >= 2 ** 31:
        raise ValueError("encode_lanes takes fewer than 2^31 words")
    dev = sym_steps.device
    words = torch.zeros((b, k, wcap), dtype=torch.int32, device=dev)
    nwords = torch.empty((b, k), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.int32, device=dev)
    err = _library().rdeic_rans_encode_lanes(
        sym_steps.data_ptr(), idx_steps.data_ptr(), valid_steps.data_ptr(),
        tables.cdf_flat.data_ptr(), tables.lengths.data_ptr(),
        tables.offsets.data_ptr(), words.data_ptr(), nwords.data_ptr(),
        ovf.data_ptr(), t_tot, b, k, wcap, tables.max_len, tables.ncdfs,
        _stream(index))
    _raise_on(err, "rans_encode_lanes")
    _tally("encode_lanes", (b, k, t_tot))
    return words, nwords, ovf.bool()


_WRAPPERS = {fn.__name__: fn
             for fn in (decode_pass, decode_pass_shared, encode_lanes)}
for _fn in _WRAPPERS.values():  # launches and calls by (B, K, T)
    _fn.launches = 0
    _fn.shapes = {}
