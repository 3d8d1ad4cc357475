"""Baseline sanity-check runner (counterpart of the root baseline_inference.py).

    python -m rdeic_torch.baseline_inference --ckpt params.npz \
        --config configs/model/rdeic.yaml --input photos/ --output out \
        [--num_images 3] [--steps 2] [--sampler ddpm|ddim] [--seed 231]

Runs N images through the whole pipeline: each is padded to a multiple of
64, coded to `out/bitstreams/<name>.rdeic`, decoded back from that file,
relay-sampled and cropped; the reconstruction is saved as `out/<name>.png`
and `out/baseline_metrics.csv` gets one row per image (name, bpp, enc_time,
dec_time, psnr, ssim, ms_ssim, lpips). The sampler's noise comes from one
`torch.Generator` seeded with `--seed`. `--ckpt` is what
`rdeic_torch.inference` takes (a flat `.npz`, a `step_N.pt` or a directory
of them). Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch

from rdeic_torch.inference import list_images, load_model
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.image import (
    encode_png, pad, read_rgb, to_float01, to_uint8)
from rdeic_torch.utils.metrics import MetricSuite, score_images

METRICS = ("psnr", "ssim", "ms_ssim", "lpips")


def process_single(model, arr: np.ndarray, stream, steps: int,
                   sampler: str = "ddpm", **noise):
    """One uint8 [H, W, 3] image through compress -> `stream` file ->
    decompress -> `decode_pipeline`. `noise`: decode_pipeline's noise
    keywords (a `generator`, or `relay_noise` and `step_noise`). Returns
    (the reconstruction [H, W, 3] float32 in [0, 1], cropped back to
    H x W; bpp of the file over H x W; encode s; decode s)."""
    H, W = arr.shape[:2]
    img01 = torch.from_numpy(to_float01(pad(arr, 64))[None]).to(
        model.codec().device)
    t0 = time.time()
    model.apply_condition_compress(img01, str(stream), img01.shape[1],
                                   img01.shape[2])
    enc_t = time.time() - t0
    t0 = time.time()
    c_latent, guide_hint = model.apply_condition_decompress(str(stream))
    out = model.decode_pipeline(c_latent, guide_hint, steps, sampler=sampler,
                                **noise)
    out01 = out[0].cpu().numpy()[:H, :W]
    dec_t = time.time() - t0
    bpp = Path(stream).stat().st_size * 8 / (H * W)
    return out01, bpp, enc_t, dec_t


def baseline_row(name: str, bpp: float, enc_t: float, dec_t: float,
                 scores: dict) -> dict:
    """A row of baseline_metrics.csv, in the root script's column order."""
    return {"name": name, "bpp": bpp, "enc_time": enc_t, "dec_time": dec_t,
            **scores}


def write_csv(path: Path, rows: list) -> None:
    with path.open("w", newline="") as fcsv:
        w = csv.DictWriter(fcsv, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--config", type=str, default="configs/model/rdeic.yaml")
    ap.add_argument("--input", type=str, required=True)
    ap.add_argument("--output", type=str, default="./baseline_out")
    ap.add_argument("--num_images", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--sampler", type=str, default="ddpm")
    ap.add_argument("--seed", type=int, default=231)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = load_model(args.config, args.ckpt, device)
    suite = MetricSuite()
    fns = {n: suite.create_metric(n) for n in METRICS}

    files = list_images(Path(args.input))[: args.num_images]
    out_dir = Path(args.output)
    (out_dir / "bitstreams").mkdir(parents=True, exist_ok=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    rows = []
    for f in files:
        name = Path(f).stem
        ref = read_rgb(f)
        out01, bpp, enc_t, dec_t = process_single(
            model, ref, out_dir / "bitstreams" / f"{name}.rdeic", args.steps,
            args.sampler, generator=generator)
        recon = to_uint8(out01)
        (out_dir / f"{name}.png").write_bytes(encode_png(recon))
        row = baseline_row(name, bpp, enc_t, dec_t,
                           score_images(fns, ref, recon, device))
        rows.append(row)
        print(row)

    write_csv(out_dir / "baseline_metrics.csv", rows)
    print(f"wrote {out_dir / 'baseline_metrics.csv'}")


if __name__ == "__main__":
    main()
