"""Tiled high-resolution serving with overlap stitching (counterpart of
rdeic_tpu/pipeline/tiled.py; the same stream files).

A large image is padded to a multiple of 64 and split into fixed-size tiles
that overlap by `overlap` pixels; the reconstructed tiles are blended with
linear ramps across the overlaps. Two stream layouts:
- v1 (independent tiles, `tiled_compress`): each tile is coded alone, its
  codec container (2 string groups, 3 with interleaved lanes) written
  verbatim after a `>6I` meta string (H, W, tile, overlap, n_th, n_tw).
- v2 (cross-tile context, `tiled_compress_xctx`, the default): only the
  memory-heavy stages are tiled. The VAE encoder runs on batches of 8 tiles
  (image by image inside, so a tile's feature is its single-tile feature),
  each tile's valid centre is stitched into the whole feature map, and the
  codec codes that map once: the entropy model sees the whole image, so the
  tiled bpp is the whole-image bpp. A `>7I` meta (2, H, W, tile, overlap,
  n_th, n_tw) precedes the codec's groups.
`tiled_decompress_decode` reads either: it decodes the latents (per tile, or
once and then cut into latent tiles), relay-samples and VAE-decodes the
tiles in batches of `tile_batch` (0: all at once; the last batch may be
smaller), and blends them.

Noise: one `noise` dict (`RDEIC.sample`'s relay_noise, step_noise) per tile
batch, or draws from `generator` batch by batch, as the JAX package draws one
key split per tile batch. Runs on the model's device; a multi-device mesh
is not ported (the CLI refuses `--use_mesh`).
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from rdeic_torch.models import blocks
from rdeic_torch.utils.bitstream import filesize, read_body, write_body
from rdeic_torch.utils.image import pad

META_FMT = ">6I"  # v1: H, W, tile, overlap, n_th, n_tw
META2_FMT = ">7I"  # v2: version (= 2), H, W, tile, overlap, n_th, n_tw
FEATURE_BATCH = 8  # tiles a VAE-encoder call takes in v2


def _tile_grid(h: int, w: int, tile: int, overlap: int):
    """Tile origins covering [0, h) x [0, w) with `overlap` pixel overlap."""
    stride = tile - overlap
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    if ys[-1] + tile < h:
        ys.append(h - tile)
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if xs[-1] + tile < w:
        xs.append(w - tile)
    return ys, xs


def _blend_weight(tile: int, overlap: int) -> np.ndarray:
    """[tile, tile, 1] linear-ramp weights for overlap blending."""
    ramp = np.ones(tile, dtype=np.float32)
    if overlap > 0:
        r = np.linspace(1.0 / (overlap + 1), 1.0, overlap, dtype=np.float32)
        ramp[:overlap] = r
        ramp[-overlap:] = r[::-1]
    return (ramp[:, None] * ramp[None, :])[..., None]


def _device(model) -> torch.device:
    return model.uncond_context.device


def _check_tile(tile: int) -> None:
    if tile % 64 != 0:
        raise ValueError(f"tile must be a multiple of 64, got {tile}")


def _write(stream_path, zshape, strings, H: int, W: int) -> float:
    with Path(stream_path).open("wb") as f:
        write_body(f, zshape, strings)
    return filesize(stream_path) * 8.0 / (H * W)


@torch.no_grad()
def tiled_compress(model, img01: np.ndarray, stream_path, tile: int = 512,
                   overlap: int = 64) -> float:
    """v1: img01 [1, H, W, 3] in [0, 1], any H and W; each tile coded alone.
    Returns the file's bpp over H x W."""
    _check_tile(tile)
    if overlap % 2 != 0:
        raise ValueError(f"overlap must be even, got {overlap}")
    H, W = img01.shape[1:3]
    padded = pad(np.asarray(img01, np.float32), 64)
    ph, pw = padded.shape[1:3]
    tile = min(tile, ph, pw)
    ys, xs = _tile_grid(ph, pw, tile, overlap)
    codec = model.codec()
    strings, zshape = [], None
    for y0 in ys:
        for x0 in xs:
            patch = torch.from_numpy(np.ascontiguousarray(
                padded[:, y0:y0 + tile, x0:x0 + tile])).to(_device(model))
            out = codec.compress(model.feature(patch))
            # the codec's container verbatim: 2 groups, 3 with lanes
            strings.extend(out["strings"])
            zshape = out["shape"]
    meta = struct.pack(META_FMT, H, W, tile, overlap, len(ys), len(xs))
    return _write(stream_path, zshape, [[meta]] + strings, H, W)


def stitched_feature(model, img01: np.ndarray, tile: int, overlap: int):
    """v2's encoder side: the VAE feature of every tile of the padded image
    (FEATURE_BATCH tiles a call, image by image inside), each tile's valid
    centre stitched into [1, H/f, W/f, C]. Returns (feature, padded size,
    clamped tile, the grid)."""
    _check_tile(tile)
    f = model.latent_factor
    if overlap % (2 * f) != 0:
        raise ValueError(f"overlap must be a multiple of {2 * f}, got {overlap}")
    padded = pad(np.asarray(img01, np.float32), 64)
    ph, pw = padded.shape[1:3]
    tile = min(tile, ph, pw)
    ys, xs = _tile_grid(ph, pw, tile, overlap)
    grid = [(y0, x0) for y0 in ys for x0 in xs]
    patches = torch.from_numpy(np.concatenate(
        [padded[:, y0:y0 + tile, x0:x0 + tile] for y0, x0 in grid])).to(
            _device(model))
    with blocks.image_by_image():
        feats = torch.cat([model.feature(patches[j:j + FEATURE_BATCH])
                           for j in range(0, len(grid), FEATURE_BATCH)])
    tf, half = tile // f, overlap // f // 2
    h_full = feats.new_zeros((1, ph // f, pw // f, feats.shape[-1]))
    for i, (y0, x0) in enumerate(grid):
        y0f, x0f = y0 // f, x0 // f
        ys_v = 0 if y0 == 0 else half
        ye_v = tf if y0 + tile >= ph else tf - half
        xs_v = 0 if x0 == 0 else half
        xe_v = tf if x0 + tile >= pw else tf - half
        h_full[:, y0f + ys_v:y0f + ye_v, x0f + xs_v:x0f + xe_v] = \
            feats[i:i + 1, ys_v:ye_v, xs_v:xe_v]
    return h_full, (ph, pw), tile, (ys, xs)


@torch.no_grad()
def tiled_compress_xctx(model, img01: np.ndarray, stream_path,
                        tile: int = 512, overlap: int = 64) -> float:
    """v2 (cross-tile context): the stitched feature map coded once.
    img01 [1, H, W, 3] in [0, 1]. Returns the file's bpp over H x W."""
    H, W = img01.shape[1:3]
    h_full, _, tile, (ys, xs) = stitched_feature(model, img01, tile, overlap)
    out = model.codec().compress(h_full)
    meta = struct.pack(META2_FMT, 2, H, W, tile, overlap, len(ys), len(xs))
    return _write(stream_path, out["shape"], [[meta]] + out["strings"], H, W)


def tile_batches(n: int, tile_batch: int) -> list[tuple[int, int]]:
    """[start, stop) of each tile batch: `tile_batch` tiles (0: all), the
    last batch ragged."""
    bs = tile_batch or n
    return [(j, min(j + bs, n)) for j in range(0, n, bs)]


def _batched_tile_decode(model, c_latent, guide_hint, steps: int,
                         sampler: str, tile_batch: int,
                         noise: Optional[Sequence[dict]],
                         generator: Optional[torch.Generator]) -> torch.Tensor:
    """Relay-sample and VAE-decode the latent tiles, a tile batch a call,
    each batch at its own size (a ragged last batch is not padded)."""
    batches = tile_batches(c_latent.shape[0], tile_batch)
    if noise is not None and len(noise) != len(batches):
        raise ValueError(f"need noise for {len(batches)} tile batches, got "
                         f"{len(noise)}")
    return torch.cat([
        model.decode_pipeline(c_latent[a:b], guide_hint[a:b], steps,
                              sampler=sampler, generator=generator,
                              **(noise[j] if noise is not None else {}))
        for j, (a, b) in enumerate(batches)])


def _blend_tiles(recon_tiles: torch.Tensor, ys, xs, tile: int, overlap: int,
                 ph: int, pw: int, H: int, W: int) -> torch.Tensor:
    """Weighted sum of the tiles over the padded canvas, over the weights'
    sum, cropped to [1, H, W, 3] (on the tiles' device)."""
    dev = recon_tiles.device
    weight = torch.from_numpy(_blend_weight(tile, overlap)).to(dev)
    acc = torch.zeros((ph, pw, 3), dtype=torch.float32, device=dev)
    wacc = torch.zeros((ph, pw, 1), dtype=torch.float32, device=dev)
    k = 0
    for y0 in ys:
        for x0 in xs:
            acc[y0:y0 + tile, x0:x0 + tile] += recon_tiles[k].float() * weight
            wacc[y0:y0 + tile, x0:x0 + tile] += weight
            k += 1
    out = acc / torch.clamp(wacc, min=1e-8)
    return out[None, :H, :W]


def read_tiled(stream_path):
    """(strings, zshape) of a tiled stream file; strings[0] is the meta."""
    with Path(stream_path).open("rb") as f:
        return read_body(f)


def decode_tile_latents(model, strings, zshape):
    """The tiles' (c_latent, guide_hint) of a tiled stream, one row per tile
    in grid order, and the grid: (c_latent, guide_hint, ys, xs, tile,
    overlap, ph, pw, H, W) in pixels."""
    meta = strings[0][0]
    codec = model.codec()
    if len(meta) == struct.calcsize(META2_FMT):
        _, H, W, tile, overlap, _, _ = struct.unpack(META2_FMT, meta)
        if len(strings) not in (3, 4):  # meta + the codec's 2 or 3 groups
            raise ValueError(
                f"corrupt cross-tile stream: {len(strings)} string groups, "
                "expected meta + y + z [+ lane table]")
        c_latent, guide_hint = codec.decompress(strings[1:], zshape)
        f = model.latent_factor
        lt, lov = tile // f, overlap // f
        lh, lw = c_latent.shape[1:3]
        lys, lxs = _tile_grid(lh, lw, lt, lov)
        cut = [(y0, x0) for y0 in lys for x0 in lxs]
        cl = torch.cat([c_latent[:, y0:y0 + lt, x0:x0 + lt] for y0, x0 in cut])
        gh = torch.cat([guide_hint[:, y0:y0 + lt, x0:x0 + lt]
                        for y0, x0 in cut])
        return (cl, gh, [y0 * f for y0 in lys], [x0 * f for x0 in lxs], tile,
                overlap, lh * f, lw * f, H, W)
    H, W, tile, overlap, n_th, n_tw = struct.unpack(META_FMT, meta)
    tiles = strings[1:]
    n_tiles = n_th * n_tw
    # per tile: 2 groups (y, z), or 3 with interleaved lanes
    gs, rem = divmod(len(tiles), n_tiles) if n_tiles else (0, 1)
    if rem or gs not in (2, 3):
        raise ValueError(f"corrupt tiled stream: {len(tiles)} tile strings "
                         f"for {n_tiles} tiles")
    lat = [codec.decompress(tiles[gs * i:gs * (i + 1)], zshape)
           for i in range(n_tiles)]
    ph, pw = -(-H // 64) * 64, -(-W // 64) * 64
    ys, xs = _tile_grid(ph, pw, tile, overlap)
    return (torch.cat([c for c, _ in lat]), torch.cat([g for _, g in lat]),
            ys, xs, tile, overlap, ph, pw, H, W)


@torch.no_grad()
def tiled_decompress_decode(model, stream_path, steps: int = 2,
                            sampler: str = "ddpm", tile_batch: int = 0,
                            noise: Optional[Sequence[dict]] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """A tiled stream file (v1 or v2, told apart by the meta's length) ->
    [1, H, W, 3] in [0, 1] on the model's device. `tile_batch` tiles are
    relay-sampled a call (0: all); `noise` has one dict per tile batch."""
    strings, zshape = read_tiled(stream_path)
    cl, gh, ys, xs, tile, overlap, ph, pw, H, W = decode_tile_latents(
        model, strings, zshape)
    recon = _batched_tile_decode(model, cl, gh, steps, sampler, tile_batch,
                                 noise, generator)
    return _blend_tiles(recon, ys, xs, tile, overlap, ph, pw, H, W)
