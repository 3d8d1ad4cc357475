"""Reference-vs-reconstruction metric tool (counterpart of the root
image_checker.py).

    python -m rdeic_torch.image_checker --ref_dir refs/ --recon_dir out/ \
        [--output ./image_check] [--save_diff]

Pairs the two folders' images by file stem, writes `check.csv` (name, psnr,
mse, mae, lpips per image) and, with `--save_diff`, `<name>_diff.png`
(|ref - recon| per channel), and prints the averages. A reconstruction of
another size is resized to the reference's (LANCZOS). LPIPS runs on
CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rdeic_torch.baseline_inference import write_csv
from rdeic_torch.data.dataset import list_image_files
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.image import encode_png, read_rgb
from rdeic_torch.utils.metrics import MetricSuite, score_images

METRICS = ("psnr", "mse", "mae", "lpips")


def resize_like(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """`b` resized (LANCZOS) to `a`'s height and width, when they differ."""
    if a.shape == b.shape:
        return b
    from PIL import Image  # noqa: PLC0415

    return np.array(Image.fromarray(b).resize((a.shape[1], a.shape[0]),
                                              Image.LANCZOS))


def diff_image(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| of two uint8 images, uint8."""
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.uint8)


def averages(rows: list) -> dict:
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]
            if k != "name"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref_dir", type=str, required=True)
    ap.add_argument("--recon_dir", type=str, required=True)
    ap.add_argument("--output", type=str, default="./image_check")
    ap.add_argument("--save_diff", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    suite = MetricSuite()
    fns = {n: suite.create_metric(n) for n in METRICS}

    refs = {Path(f).stem: f for f in list_image_files(args.ref_dir)}
    recons = {Path(f).stem: f for f in list_image_files(args.recon_dir)}
    common = sorted(set(refs) & set(recons))
    if not common:
        raise SystemExit("no matching image stems between the two folders")

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for name in common:
        a = read_rgb(refs[name])
        b = resize_like(read_rgb(recons[name]), a)
        row = {"name": name, **score_images(fns, a, b, device)}
        rows.append(row)
        print(row)
        if args.save_diff:
            (out_dir / f"{name}_diff.png").write_bytes(
                encode_png(diff_image(a, b)))

    write_csv(out_dir / "check.csv", rows)
    print("averages:", averages(rows))


if __name__ == "__main__":
    main()
