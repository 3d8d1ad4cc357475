"""Real-bitstream encode / decode of the compression model (counterpart of
the multi-program routes of rdeic_tpu/pipeline/codec.py: host rANS, and the
interleaved lanes decoded and encoded on the card).

Ten channel slices, each coded as a checkerboard anchor pass then a
non-anchor pass; the hyper latent is coded as fixed-width VQ indices.

Determinism: encode and decode call the same pass functions (A, B, CA and
C+synth) on bit-identical inputs: the hyper parameters are re-derived from
the coded VQ indices on both sides, and each slice's decoded half is rebuilt
from its integer symbols and means on both sides. `compress` and
`decompress` run in full fp32 with deterministic cuDNN algorithms chosen by
heuristics (`rdeic_torch.utils.backend.full_fp32(deterministic=True)`), so
the same functions on the same inputs give the same entropy parameters, and
the decoder reads the stream with the CDFs the encoder wrote it with. These
settings hold only inside the two calls. Symbols cross to the host once,
after the whole encode chain.

Two stream containers, as the JAX package writes them:
- two string groups (y, z): one rANS stream of every pass's symbols, read
  on the host pass by pass (pass k+1 needs the symbols of pass k);
- three groups (y, z, lane header), with `lanes` K > 0 (`RDEIC.codec` reads
  RDEIC_RANS_LANES): each pass's symbols striped over K rANS lanes, v1 with
  a size per lane or v2 one shared stream (RDEIC_RANS_SHARED, "1" by
  default), K shrunk by powers of two while the lanes' flush (~4K + 4
  bytes) exceeds RDEIC_RANS_OVERHEAD_PCT (2.0) percent of the payload.
  Decoding runs `entropy.device_rans` between the passes, so on the card
  the symbols never leave it: one `decode_pass` (v1) or
  `decode_pass_shared` (v2) kernel launch a pass. A v2 stream whose K is
  below RDEIC_RANS_DEVICE_MIN_LANES (32) decodes on the host
  (`SharedRansDecoder`), as the JAX package routes it; a codec decodes a
  stream of any K, whatever K it was built with. RDEIC_RANS_DEVICE_ENC=1
  encodes the lanes on the card (`encode_lanes`, v1 containers at the
  configured K, as the JAX package writes them), and encodes a batch on
  the host when the kernel flags an overflow. Both host routes are counted
  in `host_routes`. The four settings are the JAX codec's, read when the
  codec is built.

Batches (`compress_batch`, `decompress_batch`): the passes run once on the
[B, ...] batch, each image's symbols are cut out when they reach the host
and coded into its own stream (the lanes route pins image 0's adaptive K
for the whole batch, as the JAX package does), and each image's stream is
read by its own decoder (or its own rows of the lane kernels). Inside the
codec every convolution and product runs image by image
(`blocks.image_by_image`): a library kernel may sum in another order at
another batch size, and one ulp in a scale can move a CDF index. So a
batched stream is the stream `compress` writes for that image alone, and
row i of `decompress_batch` is `decompress` of stream i alone, bit for bit.

All tensors here are NHWC, as in the JAX package.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from rdeic_torch.entropy import device_rans
from rdeic_torch.entropy.coder import (
    BufferedRansEncoder,
    CdfTable,
    RansDecoder,
    SharedRansDecoder,
    pack_uniform,
    rans_encode_interleaved,
    rans_encode_interleaved_shared,
    rans_lanes_to_shared,
    unpack_uniform,
)
from rdeic_torch.models.blocks import image_by_image
from rdeic_torch.models.compression import CompressionModel
from rdeic_torch.ops import ckbd
from rdeic_torch.ops import gaussian as g
from rdeic_torch.utils.backend import full_fp32

# symbols travel as int16 in the JAX package's codec; larger ones refuse to
# code (encode) or to decode on the host, as there
SYM_I16_MAX = 32766
_V2_TAG = 0x80000000  # lane header: v1 = [K, nbytes x K], v2 = [TAG | K]


def _check_sym_range(maxabs: int, what: str) -> None:
    if maxabs > SYM_I16_MAX:
        raise OverflowError(f"{what} entropy symbol magnitude {maxabs} exceeds "
                            "the int16 range of the stream format")


def _pow2_at_least(n: int, lo: int = 64) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def lane_header(lanes: int, lane_nbytes) -> bytes:
    """v1 [K, each lane's bytes]; v2 (lane_nbytes None) [0x80000000 | K]."""
    if lane_nbytes is None:
        return np.asarray([_V2_TAG | lanes], dtype="<u4").tobytes()
    return np.concatenate([[lanes], np.asarray(lane_nbytes, np.uint32)]
                          ).astype("<u4").tobytes()


def parse_lane_header(hdr: bytes):
    """-> (version, lanes, lane_nbytes or None). Raises ValueError on a
    header no codec writes (a corrupt stream): no lanes, a v2 K past the
    shared kernel's MAX_SHARED_LANES, or a v1 header without one byte count
    a lane."""
    arr = np.frombuffer(hdr, "<u4", len(hdr) // 4)
    tag = int(arr[0]) if arr.size else 0
    ver, k = (2, tag & ~_V2_TAG) if tag & _V2_TAG else (1, tag)
    if k < 1 or (ver == 2 and (k > device_rans.MAX_SHARED_LANES
                               or arr.size != 1)) \
            or (ver == 1 and arr.size != 1 + k):
        raise ValueError(f"corrupt lanes header: v{ver}, K = {k}, "
                         f"{len(hdr)} bytes")
    return ver, k, None if ver == 2 else arr[1:].astype(np.int64)


class CompressionCodec:
    """The compression model plus its CDF tables and per-slice passes.
    `lanes` > 0 writes interleaved-lane containers (see the module)."""

    def __init__(self, model: CompressionModel, lanes: int = 0):
        self.model = model
        self.scale_table = g.get_scale_table()
        self.table = CdfTable(*g.build_cdf_tables(self.scale_table))
        self.bounds = []
        lo = 0
        for c in model.slice_ch:
            self.bounds.append((lo, lo + c))
            lo += c
        # the JAX codec's settings, read here as it reads them
        self.lanes = int(lanes)
        self.device_enc = bool(self.lanes) and (
            os.environ.get("RDEIC_RANS_DEVICE_ENC", "0") == "1")
        self.shared = os.environ.get("RDEIC_RANS_SHARED", "1") == "1"
        self.auto_lanes_pct = float(
            os.environ.get("RDEIC_RANS_OVERHEAD_PCT", "2.0"))
        self.device_min_lanes = int(
            os.environ.get("RDEIC_RANS_DEVICE_MIN_LANES", "32"))
        # calls that took the JAX package's host routes of the lanes codec
        self.host_routes = {"shared_decode": 0, "encode_after_overflow": 0}
        self._tabs = None

    @property
    def device(self) -> torch.device:
        return self.model.quantize.embedding.device

    def tables(self) -> device_rans.DeviceRansTables:
        """The CDF tables and LUT on the model's device, made once."""
        if self._tabs is None or self._tabs.device != self.device:
            self._tabs = device_rans.DeviceRansTables(self.table, self.device)
        return self._tabs

    # -- the passes shared by encode and decode -----------------------------
    def hyper_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.model.hyper_decode(self.model.vq_lookup(indices))

    def pass_a(self, idx: int, hyper, y_hat_prev):
        """Anchor means and CDF indexes of slice idx (+ its channel ctx)."""
        scales, means, channel_ctx = self.model.params_anchor(idx, hyper, y_hat_prev)
        indexes = g.build_indexes(ckbd.ckbd_anchor_squeeze(scales),
                                  self.scale_table)
        return ckbd.ckbd_anchor_squeeze(means), indexes, channel_ctx

    def pass_b(self, idx: int, sym_a, means_a_sq, hyper, channel_ctx):
        """Dequantize the anchor half; non-anchor means and indexes."""
        anchor_half = ckbd.ckbd_anchor_unsqueeze(sym_a.float() + means_a_sq)
        scales, means = self.model.params_nonanchor(idx, hyper, channel_ctx,
                                                    anchor_half)
        indexes = g.build_indexes(ckbd.ckbd_nonanchor_squeeze(scales),
                                  self.scale_table)
        return anchor_half, ckbd.ckbd_nonanchor_squeeze(means), indexes

    @staticmethod
    def pass_c(sym_na, means_na_sq, anchor_half, y_hat_prev):
        """Assemble the slice and append it to the slices decoded so far."""
        y_hat_slice = anchor_half + ckbd.ckbd_nonanchor_unsqueeze(
            sym_na.float() + means_na_sq)
        if y_hat_prev is None:
            return y_hat_slice
        return torch.cat([y_hat_prev, y_hat_slice], dim=-1)

    def pass_ca(self, idx: int, sym_na, means_na_sq, anchor_half, y_hat_prev,
                hyper):
        """pass_c of slice idx-1, then pass_a of slice idx."""
        y_hat_prev = self.pass_c(sym_na, means_na_sq, anchor_half, y_hat_prev)
        return (y_hat_prev,) + self.pass_a(idx, hyper, y_hat_prev)

    def pass_c_synth(self, sym_na, means_na_sq, anchor_half, y_hat_prev):
        """The last slice's pass_c, then the synthesis transform."""
        y_hat = self.pass_c(sym_na, means_na_sq, anchor_half, y_hat_prev)
        return self.model.synthesize(y_hat)

    # -- encode -----------------------------------------------------------------
    def _encode_chain(self, x: torch.Tensor):
        """The encode chain on a batch x [B, H, W, in_nc]: (VQ indices,
        symbols and CDF indexes of every pass in coding order, the
        synthesis of the decoded slices)."""
        y, z = self.model.analyze(x)
        _, indices = self.model.vq_quant(z)
        hyper = self.hyper_from_indices(indices)
        syms, idxs = [], []
        y_hat_prev = None
        means_a, idx_a, channel_ctx = self.pass_a(0, hyper, None)
        for i, (lo, hi) in enumerate(self.bounds):
            y_slice = y[..., lo:hi]
            sym_a = torch.round(ckbd.ckbd_anchor_squeeze(y_slice) - means_a).int()
            anchor_half, means_na, idx_na = self.pass_b(
                i, sym_a, means_a, hyper, channel_ctx)
            sym_na = torch.round(
                ckbd.ckbd_nonanchor_squeeze(y_slice) - means_na).int()
            syms += [sym_a, sym_na]
            idxs += [idx_a, idx_na]
            if i < len(self.bounds) - 1:
                y_hat_prev, means_a, idx_a, channel_ctx = self.pass_ca(
                    i + 1, sym_na, means_na, anchor_half, y_hat_prev, hyper)
        latents = self.pass_c_synth(sym_na, means_na, anchor_half, y_hat_prev)
        return indices, syms, idxs, latents

    def _streams(self, indices, syms, idxs) -> list[dict]:
        """One {strings, shape} per image of the batch: the symbols cross
        to the host once, then each image's rows are coded alone."""
        if self.lanes and self.device_enc:
            outs = self._streams_device_enc(indices, syms, idxs)
            if outs is not None:
                return outs
        maxabs = torch.stack([s.abs().max() for s in syms]).max()
        indices_np = indices.cpu().numpy()
        _check_sym_range(int(maxabs), "encoded")
        syms = [s.cpu().numpy() for s in syms]
        idxs = [ix.cpu().numpy() for ix in idxs]
        if self.lanes:
            return self._lane_streams(syms, idxs, indices_np)
        outs = []
        for img in range(indices_np.shape[0]):
            enc = BufferedRansEncoder()
            for s, ix in zip(syms, idxs):
                enc.encode_with_indexes(s[img], ix[img])
            outs.append({
                "strings": [[enc.flush(self.table)],
                            [pack_uniform(indices_np[img],
                                          self.model.codebook_size)]],
                "shape": (indices_np.shape[1], indices_np.shape[2])})
        return outs

    def _lane_container(self, payload: bytes, lane_nbytes, indices_np,
                        img: int, k: int) -> dict:
        return {"strings": [[payload],
                            [pack_uniform(indices_np[img],
                                          self.model.codebook_size)],
                            [lane_header(k, lane_nbytes)]],
                "shape": (indices_np.shape[1], indices_np.shape[2])}

    def pick_lanes(self, data_bytes: int) -> int:
        """The largest power-of-two K <= `lanes` whose flush (~4K + 4
        bytes) stays under `auto_lanes_pct` percent of the data bytes (at
        least 2; `lanes` when the percentage is 0)."""
        if self.auto_lanes_pct <= 0:
            return self.lanes
        budget = data_bytes * self.auto_lanes_pct / 100.0
        k = self.lanes
        while k > 2 and 4 * k + 4 > budget:
            k //= 2
        return max(k, 2)

    def _flush_lanes(self, syms, idxs, indices_np, img: int,
                     k_fixed: int | None = None) -> dict:
        """Image `img`'s lanes container from the host's per-pass symbols:
        v1 at `lanes`, or v2 at the adaptive K (or at `k_fixed`, the batch's
        pinned K): the JAX package's `_flush_interleaved`."""
        flat_s = [np.asarray(s[img]).reshape(-1) for s in syms]
        flat_i = [np.asarray(ix[img]).reshape(-1) for ix in idxs]
        pass_sizes = [s.shape[0] for s in flat_s]
        cat_s, cat_i = np.concatenate(flat_s), np.concatenate(flat_i)
        if not self.shared:
            payload, lane_nbytes = rans_encode_interleaved(
                cat_s, cat_i, pass_sizes, self.lanes, self.table)
            return self._lane_container(payload, lane_nbytes, indices_np, img,
                                        self.lanes)
        if k_fixed is not None and k_fixed != self.lanes:
            payload = rans_encode_interleaved_shared(
                cat_s, cat_i, pass_sizes, k_fixed, self.table)
            return self._lane_container(payload, None, indices_np, img, k_fixed)
        payload, lane_nbytes = rans_encode_interleaved(
            cat_s, cat_i, pass_sizes, self.lanes, self.table)
        # the data bytes: the payload less ~6 bytes of flush a lane
        k = (k_fixed if k_fixed is not None
             else self.pick_lanes(max(len(payload) - 6 * self.lanes, 0)))
        if k == self.lanes:
            payload = rans_lanes_to_shared(payload, lane_nbytes, cat_i,
                                           pass_sizes, self.table)
        else:
            payload = rans_encode_interleaved_shared(
                cat_s, cat_i, pass_sizes, k, self.table)
        return self._lane_container(payload, None, indices_np, img, k)

    def _lane_streams(self, syms, idxs, indices_np) -> list[dict]:
        """Every image's lanes container; v2 pins image 0's adaptive K for
        the whole batch, so the batch decodes at one K."""
        outs, k_fixed = [], None
        for img in range(indices_np.shape[0]):
            out = self._flush_lanes(syms, idxs, indices_np, img, k_fixed)
            if self.shared and k_fixed is None:
                k_fixed = parse_lane_header(out["strings"][2][0])[1]
            outs.append(out)
        return outs

    def _streams_device_enc(self, indices, syms, idxs):
        """The lanes encoded on the model's device (`encode_lanes`, v1 at
        `lanes`): only the words, their counts, the overflow flag and the
        symbols' range cross to the host. None when the kernel flags an
        overflow: the caller then encodes on the host, as the JAX package
        does."""
        steps = device_rans.build_pass_steps(syms, idxs, self.lanes)
        wcap = _pow2_at_least(int(steps[0].shape[0]) + 2)
        words, nwords, ovf = device_rans.encode_lanes(self.tables(), *steps,
                                                      wcap)
        maxabs = torch.stack([s.abs().max() for s in syms]).max()
        indices_np, nwords_np = indices.cpu().numpy(), nwords.cpu().numpy()
        _check_sym_range(int(maxabs), "encoded")
        if bool(ovf):
            warnings.warn("device rANS encode overflowed its word capacity; "
                          "encoding this batch on the host")
            self.host_routes["encode_after_overflow"] += 1
            return None
        wb = _pow2_at_least(max(int(nwords_np.max()), 1))
        words_np = words[:, :, :wb].cpu().numpy()
        return [self._lane_container(
            *device_rans.assemble_lane_payloads(words_np[img], nwords_np[img]),
            indices_np, img, self.lanes)
            for img in range(nwords_np.shape[0])]

    @torch.no_grad()
    @image_by_image()
    @full_fp32(deterministic=True)
    def compress(self, x: torch.Tensor) -> dict:
        """x: [1, H, W, in_nc] scaled VAE feature -> {strings, shape,
        latents}. `latents` is the encoder's own synthesis of the decoded
        slices, (c_latent, guide_hint): what `decompress` must reproduce bit
        for bit from the strings."""
        indices, syms, idxs, latents = self._encode_chain(x)
        return {**self._streams(indices, syms, idxs)[0], "latents": latents}

    @torch.no_grad()
    @image_by_image()
    @full_fp32(deterministic=True)
    def compress_batch(self, x: torch.Tensor) -> list[dict]:
        """x: [B, H, W, in_nc] -> one {strings, shape} per image. The passes
        run once on the batch; each image gets its own stream, which
        decodes alone and equals what `compress` writes for that image."""
        return self._streams(*self._encode_chain(x)[:3])

    # -- decode -----------------------------------------------------------------
    @torch.no_grad()
    @image_by_image()
    @full_fp32(deterministic=True)
    def decompress(self, strings, shape):
        """strings/shape -> (c_latent, guide_hint), NHWC."""
        return self._decode([{"strings": strings, "shape": shape}])

    @torch.no_grad()
    @image_by_image()
    @full_fp32(deterministic=True)
    def decompress_batch(self, outs: list[dict]):
        """One {strings, shape} per image (one padded size) -> (c_latent,
        guide_hint) of the batch: the passes run once on the batch, each
        image's stream is read by its own decoder; row i equals
        `decompress` of stream i alone."""
        return self._decode(outs)

    def _decode(self, outs: list[dict]):
        groups = {len(o["strings"]) for o in outs}
        if len(groups) != 1 or not groups <= {2, 3}:
            raise ValueError(f"a batch decodes containers of 2 or 3 string "
                             f"groups, all alike; got {sorted(groups)}")
        if groups == {2}:
            return self._decode_host(outs)
        heads = {parse_lane_header(o["strings"][2][0])[:2] for o in outs}
        if len(heads) != 1:
            raise ValueError(f"a batch decodes lanes of one version and K, got "
                             f"{sorted(heads)}")
        ((ver, k),) = heads
        if ver == 2 and k < self.device_min_lanes:
            self.host_routes["shared_decode"] += 1
            return self._decode_shared_host(outs, k)
        return self._decode_lanes(outs, ver, k)

    def _hyper(self, outs: list[dict]) -> torch.Tensor:
        zh, zw = (int(v) for v in outs[0]["shape"])
        if any(tuple(int(v) for v in o["shape"]) != (zh, zw) for o in outs):
            raise ValueError("a batch decodes streams of one shape")
        indices = np.stack([
            unpack_uniform(o["strings"][1][0], zh * zw,
                           self.model.codebook_size).reshape(zh, zw)
            for o in outs])
        return self.hyper_from_indices(torch.from_numpy(indices).to(self.device))

    def _decode_chain(self, hyper: torch.Tensor, decode):
        """The passes from `hyper`, each pass's symbols from `decode(idx)`
        (CDF indexes [B, ...] -> symbols of the same shape)."""
        y_hat_prev = None
        means_a, idx_a, channel_ctx = self.pass_a(0, hyper, None)
        last = len(self.bounds) - 1
        for i in range(len(self.bounds)):
            anchor_half, means_na, idx_na = self.pass_b(
                i, decode(idx_a), means_a, hyper, channel_ctx)
            sym_na = decode(idx_na)
            if i < last:
                y_hat_prev, means_a, idx_a, channel_ctx = self.pass_ca(
                    i + 1, sym_na, means_na, anchor_half, y_hat_prev, hyper)
            else:
                return self.pass_c_synth(sym_na, means_na, anchor_half,
                                         y_hat_prev)
        raise ValueError("the model has no slices")

    def _host_symbols(self, decode_row):
        """A `decode` of the host routes: each image's symbols of a pass
        from `decode_row(image, its indexes)`, checked to the int16 range."""
        def decode(idx: torch.Tensor) -> torch.Tensor:
            idx_np = idx.cpu().numpy().astype(np.int32)
            sym = np.stack([decode_row(i, ix).reshape(ix.shape)
                            for i, ix in enumerate(idx_np)])
            if sym.size:
                _check_sym_range(int(np.abs(sym).max()), "decoded")
            return torch.from_numpy(sym).to(self.device)
        return decode

    def _decode_host(self, outs: list[dict]):
        """Two-group streams: each image's one stream on the host."""
        hyper = self._hyper(outs)
        decs = [RansDecoder() for _ in outs]
        try:
            for d, o in zip(decs, outs):
                d.set_stream(o["strings"][0][0])
            return self._decode_chain(hyper, self._host_symbols(
                lambda i, ix: decs[i].decode_stream(ix, self.table)))
        finally:
            for d in decs:
                d.close()

    def _decode_shared_host(self, outs: list[dict], k: int):
        """v2 streams below `device_min_lanes`: the passes on the model's
        device, the symbols from each image's `SharedRansDecoder`."""
        hyper = self._hyper(outs)
        decs = [SharedRansDecoder(o["strings"][0][0], k) for o in outs]
        try:
            return self._decode_chain(hyper, self._host_symbols(
                lambda i, ix: decs[i].decode_pass(ix, self.table)))
        finally:
            for d in decs:
                d.close()

    def _lane_words(self, outs: list[dict], ver: int, k: int):
        """The batch's words on the model's device: v1 [B, K, W] with
        nwords [B, K], v2 [B, W] with nwords [B]; W a power of two >= 64,
        as the JAX package pads it."""
        if ver == 2:
            mats = [device_rans.shared_words_from_bytes(o["strings"][0][0])
                    for o in outs]
            words = np.zeros((len(outs), _pow2_at_least(max(m[1] for m in mats))),
                             np.int32)
            nwords = np.zeros(len(outs), np.int32)
            for i, (w, nw) in enumerate(mats):
                words[i, :w.shape[0]] = w
                nwords[i] = nw
        else:
            mats = [device_rans.lanes_from_bytes(
                o["strings"][0][0], parse_lane_header(o["strings"][2][0])[2])
                for o in outs]
            words = np.zeros((len(outs), k, _pow2_at_least(
                max(m[0].shape[1] for m in mats))), np.int32)
            nwords = np.zeros((len(outs), k), np.int32)
            for i, (w, nw) in enumerate(mats):
                words[i, :, :w.shape[1]] = w
                nwords[i] = nw
        return (torch.from_numpy(words).to(self.device),
                torch.from_numpy(nwords).to(self.device))

    def _decode_lanes(self, outs: list[dict], ver: int, k: int):
        """Lane streams decoded between the passes by `device_rans`: the
        symbols stay on the model's device (int16, as the JAX package's
        device decode hands them on)."""
        hyper = self._hyper(outs)
        words, nwords = self._lane_words(outs, ver, k)
        tabs = self.tables()
        if ver == 2:
            state = device_rans.init_shared_state(words, nwords, k)
            decode_pass = device_rans.decode_pass_shared
        else:
            state = device_rans.init_lane_state(words, nwords)
            decode_pass = device_rans.decode_pass

        def decode(idx: torch.Tensor) -> torch.Tensor:
            nonlocal state
            b, n = idx.shape[0], idx[0].numel()
            flat = torch.nn.functional.pad(idx.reshape(b, n).to(torch.int32),
                                           (0, (-n) % k))
            sym, state = decode_pass(tabs, words, nwords, *state,
                                     flat.contiguous(), n)
            return sym[:, :n].reshape(idx.shape).to(torch.int16)

        return self._decode_chain(hyper, decode)
