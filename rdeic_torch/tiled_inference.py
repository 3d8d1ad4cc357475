"""Tiled high-resolution serving CLI (counterpart of the root
tiled_inference.py).

    python -m rdeic_torch.tiled_inference --ckpt params.npz \
        --config configs/model/rdeic.yaml --input photos/ --output out \
        [--tile 512] [--overlap 64] [--tile_batch 0] [--independent_tiles]

Each image is split into overlapping tiles (`rdeic_torch.pipeline.tiled`),
coded to `out/bitstreams/<name>.rdeic` (cross-tile context by default: the
whole feature map coded once; `--independent_tiles` codes each tile alone),
decoded back from that file, relay-sampled `--tile_batch` tiles at a time
(0: all tiles in one call), blended and saved as `out/<name>.png`, with the
root CLI's line per image (bpp over the image, PSNR, encode and decode
seconds). `--bf16` serves the VAE and the denoiser in bf16; the codec stays
fp32. Noise comes from one `torch.Generator` seeded with `--seed`. The
interleaved-lane codec is chosen by the RDEIC_RANS_* settings
(pipeline/codec.py). `--use_mesh` (a tile batch sharded over several
devices) is refused: ROADMAP Queue 1, multi-device. Runs on CUDA unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from rdeic_torch.inference import list_images, load_model
from rdeic_torch.pipeline.tiled import (
    tiled_compress,
    tiled_compress_xctx,
    tiled_decompress_decode,
)
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.image import to_float01, to_uint8
from rdeic_torch.utils.metrics import MetricSuite


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="flat .npz of JAX params, a step_N.pt train state, "
                         "or a directory of them (the latest step)")
    ap.add_argument("--config", default="configs/model/rdeic.yaml")
    ap.add_argument("--input", required=True, help="image file or dir")
    ap.add_argument("--output", required=True)
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--overlap", type=int, default=64)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"])
    ap.add_argument("--tile_batch", type=int, default=0,
                    help="tiles relay-sampled a call (0 = all)")
    ap.add_argument("--use_mesh", action="store_true",
                    help="shard the tile batch across all local devices")
    ap.add_argument("--independent_tiles", action="store_true",
                    help="v1 layout: each tile coded alone (default: "
                         "cross-tile context, the whole feature map coded "
                         "once)")
    ap.add_argument("--seed", type=int, default=231)
    ap.add_argument("--bf16", action="store_true",
                    help="serve the VAE and the denoiser in bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.use_mesh:
        raise NotImplementedError("--use_mesh: one device only; serving over "
                                  "several is ROADMAP Queue 1, multi-device")

    from PIL import Image  # noqa: PLC0415 (only the CLI reads images)

    device = resolve_device(args.device)
    model = load_model(args.config, args.ckpt, device)
    if args.bf16:
        model.set_compute_dtype(torch.bfloat16)
    psnr_f = MetricSuite().create_metric("psnr")
    out_dir = Path(args.output)
    (out_dir / "bitstreams").mkdir(parents=True, exist_ok=True)
    compress = tiled_compress if args.independent_tiles else tiled_compress_xctx
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for fp in list_images(Path(args.input)):
        name = Path(fp).stem
        arr = np.array(Image.open(fp).convert("RGB"))
        H, W = arr.shape[:2]
        stream = out_dir / "bitstreams" / f"{name}.rdeic"
        t0 = time.time()
        bpp = compress(model, to_float01(arr)[None], stream, tile=args.tile,
                       overlap=args.overlap)
        enc_t = time.time() - t0
        t0 = time.time()
        out01 = tiled_decompress_decode(
            model, stream, steps=args.steps, sampler=args.sampler,
            tile_batch=args.tile_batch, generator=generator)
        recon = to_uint8(out01[0].float().cpu().numpy())
        dec_t = time.time() - t0
        Image.fromarray(recon).save(out_dir / f"{name}.png")
        a, b = (torch.from_numpy(x.astype(np.float32) / 255.0)[None]
                for x in (arr, recon))
        p = float(psnr_f(a, b)[0])
        print(f"{name} ({H}x{W}): bpp={bpp:.5f} psnr={p:.2f} "
              f"enc={enc_t:.2f}s dec={dec_t:.2f}s")


if __name__ == "__main__":
    main()
