"""Robustness sweep: corruption rates x seeds over bitstream and latent faults
(counterpart of the root experiments/run_robustness.py).

    python -m rdeic_torch.experiments.run_robustness --ckpt params.npz \
        --config configs/model/rdeic.yaml --input photos/ \
        [--output ./robustness_out] [--num_images 1] [--seeds 0 1 2] \
        [--error_rates 0 1e-4 ...] [--latent_severities 0 0.05 ...] \
        [--targets bitstream:random bitstream:burst latent:mask_replace \
         latent:additive]

Each image is coded once to `<output>/streams/<name>.rdeic` (a stream
already there is reused). Then for each target, severity and seed: a
`bitstream` target flips bits of the stream's payload (the 12-byte
container header is kept, so its lengths still parse) and decodes the
corrupted file; a `latent` target decodes the clean stream and corrupts
the decoded latent. Each is relay-sampled and scored (PSNR, MS-SSIM,
LPIPS). A decode that raises gives a `decode_failed` row with its error,
and the sweep goes on. Writes `robustness_results.csv` (one row a run,
columns sorted) and `robustness_summary.csv` (fail rate and mean metrics
per target, mode and severity). The noise comes from one `torch.Generator`
seeded with 0, one draw a row. Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from rdeic_torch.experiments.corruptors import Corruptor
from rdeic_torch.inference import list_images, load_model
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.image import pad, read_rgb, to_float01, to_uint8
from rdeic_torch.utils.metrics import MetricSuite, score_images

METRICS = ("psnr", "ms_ssim", "lpips")
HEADER_BYTES = 12  # the container's (zH, zW, n_strings)


def sweep_image(model, arr: np.ndarray, name: str, clean_stream: Path,
                corrupt_stream: Path, targets, error_rates, latent_severities,
                seeds, steps: int, fns: dict,
                noise: Callable[[], dict]) -> Iterator[tuple]:
    """Yields (row, reconstruction uint8 or None when the decode failed)
    for each target ("bitstream:random|burst", "latent:mask_replace|
    additive"), severity and seed, on one uint8 [H, W, 3] image.
    `clean_stream` is coded first unless it exists; `noise()` gives each
    row's decode_pipeline keywords, drawn before the row runs."""
    H, W = arr.shape[:2]
    device = model.codec().device
    if not clean_stream.exists():
        img01 = torch.from_numpy(to_float01(pad(arr, 64))[None]).to(device)
        model.apply_condition_compress(img01, str(clean_stream),
                                       img01.shape[1], img01.shape[2])
    bpp = clean_stream.stat().st_size * 8 / (H * W)
    for target_mode in targets:
        target, mode = target_mode.split(":")
        severities = (error_rates if target == "bitstream"
                      else latent_severities)
        for sev in severities:
            for seed in seeds:
                kw = noise()
                row = dict(image=name, target=target, mode=mode, severity=sev,
                           seed=seed, bpp=bpp, decode_failed=False)
                recon = None
                try:
                    if target == "bitstream":
                        raw = clean_stream.read_bytes()
                        cor = Corruptor("bitstream", mode, sev, seed)
                        corrupt_stream.write_bytes(
                            raw[:HEADER_BYTES]
                            + cor.apply_bytes(raw[HEADER_BYTES:]))
                        c_latent, guide_hint = model.apply_condition_decompress(
                            str(corrupt_stream))
                    else:
                        c_latent, guide_hint = model.apply_condition_decompress(
                            str(clean_stream))
                        cor = Corruptor("latent", mode, sev, seed)
                        c_latent = torch.from_numpy(cor.apply_latent(
                            c_latent.cpu().numpy())).to(device)
                    out = model.decode_pipeline(c_latent, guide_hint, steps,
                                                **kw)
                    recon = to_uint8(out[0].cpu().numpy())[:H, :W]
                    row.update(score_images(fns, arr, recon, device))
                except Exception as e:  # noqa: BLE001 (a corrupt stream may
                    # fail anywhere in the decode: the row records it and
                    # the sweep goes on)
                    recon = None
                    row["decode_failed"] = True
                    row["error"] = f"{type(e).__name__}: {e}"[:200]
                    for n in fns:
                        row[n] = float("nan")
                yield row, recon


def summary_rows(rows: list) -> list:
    """[target, mode, severity, n, fail_rate, psnr, ms_ssim, lpips] per
    (target, mode, severity), sorted; each metric the mean of the finite
    values (NaN where none is)."""
    groups = {}
    for r in rows:
        groups.setdefault((r["target"], r["mode"], r["severity"]), []).append(r)
    out = []
    for (t, m, s), rs in sorted(groups.items()):
        fail = float(np.mean([r["decode_failed"] for r in rs]))
        stats = []
        for n in METRICS:
            vals = [r[n] for r in rs if n in r and np.isfinite(r[n])]
            stats.append(float(np.mean(vals)) if vals else float("nan"))
        out.append([t, m, s, len(rs), fail] + stats)
    return out


def write_results(out_dir: Path, rows: list) -> list:
    """robustness_results.csv (every row, the columns sorted) and
    robustness_summary.csv; returns the summary rows."""
    fields = sorted({k for r in rows for k in r})
    with (out_dir / "robustness_results.csv").open("w", newline="") as fcsv:
        w = csv.DictWriter(fcsv, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    summary = summary_rows(rows)
    with (out_dir / "robustness_summary.csv").open("w", newline="") as fcsv:
        w = csv.writer(fcsv)
        w.writerow(["target", "mode", "severity", "n", "fail_rate", *METRICS])
        w.writerows(summary)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--config", type=str, default="configs/model/rdeic.yaml")
    ap.add_argument("--input", type=str, required=True)
    ap.add_argument("--output", type=str, default="./robustness_out")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--num_images", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--error_rates", type=float, nargs="+",
                    default=[0.0, 0.0001, 0.001, 0.005, 0.01, 0.02])
    ap.add_argument("--targets", type=str, nargs="+",
                    default=["bitstream:random", "bitstream:burst",
                             "latent:mask_replace", "latent:additive"])
    ap.add_argument("--latent_severities", type=float, nargs="+",
                    default=[0.0, 0.05, 0.1, 0.2, 0.5])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = load_model(args.config, args.ckpt, device)
    suite = MetricSuite()
    fns = {n: suite.create_metric(n) for n in METRICS}

    files = list_images(Path(args.input))[: args.num_images]
    out_dir = Path(args.output)
    (out_dir / "streams").mkdir(parents=True, exist_ok=True)

    generator = torch.Generator(device=device).manual_seed(0)
    rows = []
    for f in files:
        name = Path(f).stem
        for row, _ in sweep_image(
                model, read_rgb(f), name, out_dir / "streams" / f"{name}.rdeic",
                out_dir / "streams" / "_corrupt.rdeic", args.targets,
                args.error_rates, args.latent_severities, args.seeds,
                args.steps, fns, lambda: {"generator": generator}):
            rows.append(row)
            print(row)

    write_results(out_dir, rows)
    print(f"wrote {out_dir}/robustness_results.csv and summary")


if __name__ == "__main__":
    main()
