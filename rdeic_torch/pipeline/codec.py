"""Real-bitstream encode / decode of the compression model (counterpart of the
multi-program host-rANS route of rdeic_tpu/pipeline/codec.py).

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
settings hold only inside the two calls. Symbols cross to the host once, after the whole encode chain; the
decoder is host-interactive by nature (pass k+1 needs the symbols pass k
decodes).

Batches (`compress_batch`, `decompress_batch`): the passes run once on the
[B, ...] batch, each image's symbols are cut out when they reach the host
and coded into its own stream, and each image's stream is read by its own
decoder, pass by pass. Inside the codec every convolution and product runs
image by image (`blocks.image_by_image`): a library kernel may sum in
another order at another batch size, and one ulp in a scale can move a CDF
index. So a batched stream is the stream `compress` writes for that image
alone, and row i of `decompress_batch` is `decompress` of stream i alone,
bit for bit. The lanes and shared-stream container of the JAX package's
device-side coder (more than two strings) is refused.

All tensors here are NHWC, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from rdeic_torch.entropy.coder import (
    BufferedRansEncoder,
    CdfTable,
    RansDecoder,
    pack_uniform,
    unpack_uniform,
)
from rdeic_torch.models.blocks import image_by_image
from rdeic_torch.models.compression import CompressionModel
from rdeic_torch.ops import ckbd
from rdeic_torch.ops import gaussian as g
from rdeic_torch.utils.backend import full_fp32


class CompressionCodec:
    """The compression model plus its CDF tables and per-slice passes."""

    def __init__(self, model: CompressionModel):
        self.model = model
        self.scale_table = g.get_scale_table()
        self.table = CdfTable(*g.build_cdf_tables(self.scale_table))
        self.bounds = []
        lo = 0
        for c in model.slice_ch:
            self.bounds.append((lo, lo + c))
            lo += c

    @property
    def device(self) -> torch.device:
        return self.model.quantize.embedding.device

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

    # -- encode / decode -----------------------------------------------------
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
        indices_np = indices.cpu().numpy()
        syms = [s.cpu().numpy() for s in syms]
        idxs = [ix.cpu().numpy() for ix in idxs]
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

    @torch.no_grad()
    @image_by_image()
    @full_fp32(deterministic=True)
    def decompress(self, strings, shape):
        """strings/shape -> (c_latent, guide_hint), NHWC."""
        return self._decode_chain([{"strings": strings, "shape": shape}])

    @torch.no_grad()
    @image_by_image()
    @full_fp32(deterministic=True)
    def decompress_batch(self, outs: list[dict]):
        """One {strings, shape} per image (one padded size) -> (c_latent,
        guide_hint) of the batch: the passes run once on the batch, each
        image's stream is read by its own decoder; row i equals
        `decompress` of stream i alone."""
        return self._decode_chain(outs)

    def _decode_chain(self, outs: list[dict]):
        if any(len(o["strings"]) > 2 for o in outs):
            raise NotImplementedError(
                "the lanes and shared-stream container (more than two "
                "strings): ROADMAP Queue 1, entropy/device_rans.py")
        zh, zw = (int(v) for v in outs[0]["shape"])
        if any(tuple(int(v) for v in o["shape"]) != (zh, zw) for o in outs):
            raise ValueError("a batch decodes streams of one shape")
        indices = np.stack([
            unpack_uniform(o["strings"][1][0], zh * zw,
                           self.model.codebook_size).reshape(zh, zw)
            for o in outs])
        hyper = self.hyper_from_indices(torch.from_numpy(indices).to(self.device))
        decs = [RansDecoder() for _ in outs]
        try:
            for d, o in zip(decs, outs):
                d.set_stream(o["strings"][0][0])

            def decode(idx: torch.Tensor) -> torch.Tensor:
                """Each image's symbols of one pass, from its own stream."""
                idx_np = idx.cpu().numpy()
                sym = np.stack([d.decode_stream(ix, self.table).reshape(ix.shape)
                                for d, ix in zip(decs, idx_np)])
                return torch.from_numpy(sym).to(self.device)

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
        finally:
            for d in decs:
                d.close()
        raise ValueError("the model has no slices")
