"""OOD domain evaluation harness (counterpart of the root
experiments/run_ood.py).

    python -m rdeic_torch.experiments.run_ood --ckpt params.npz \
        --config configs/model/rdeic.yaml --input sat/,sketch.list \
        [--domain sat,sketch] [--output ./ood_out] [--tta_samples 4] \
        [--nr_metrics [--niqe_model n.npz] [--brisque_model b.npz]]

Each comma-separated --input entry (an image folder, a `.list` file or one
image) is a domain. Each image is coded to `<output>/<domain>/bitstreams/
<name>.rdeic`, decoded from it, relay-sampled `--tta_samples` times with
fresh noise (test-time augmentation: the draw with the lowest LPIPS is
kept), saved as `<output>/<domain>/<name>.png` and scored: bpp, PSNR,
MS-SSIM, LPIPS and, with --nr_metrics, NIQE and BRISQUE (each loaded from
its .npz, or fit on the domain's first 24 originals of 96 px a side or
more). Each domain writes `ood_metrics.csv`; two or more also write
`ood_results_all.csv` and print each domain's mean and std. The noise
comes from one `torch.Generator` seeded with --seed, carried across the
domains. Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from rdeic_torch.baseline_inference import write_csv
from rdeic_torch.data.dataset import list_image_files, load_file_list
from rdeic_torch.inference import load_model
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.brisque import BRISQUEModel
from rdeic_torch.utils.image import encode_png, pad, read_rgb, to_float01, to_uint8
from rdeic_torch.utils.metrics import MetricSuite, score_images
from rdeic_torch.utils.niqe import NIQEModel

METRICS = ("psnr", "ms_ssim", "lpips")
PRISTINE_IMAGES = 24  # originals a self-fit reads, the first of the domain
PRISTINE_MIN_SIDE = 96  # NIQE's patch


def domain_files(input_path: str, num_images: int = 0) -> list[str]:
    """A domain's images: the lines of a `.list` file, one image file, or
    a folder's images; the first `num_images` when it is not 0."""
    p = Path(input_path)
    if p.is_file() and p.suffix == ".list":
        files = load_file_list(str(p))
    elif p.is_file():
        files = [str(p)]
    else:
        files = list_image_files(str(p))
    return files[:num_images] if num_images else files


def nr_models(niqe_model: str | None, brisque_model: str | None,
              originals: Iterable[np.ndarray]) -> dict:
    """The no-reference models: each loaded from its .npz when given, else
    fit on the uint8 `originals` of PRISTINE_MIN_SIDE px a side or more
    (read only when a model is to be fit): the in-domain clean images are
    the naturalness the reconstructions should match."""
    models = {}
    if niqe_model:
        models["niqe"] = NIQEModel.load(niqe_model)
    if brisque_model:
        models["brisque"] = BRISQUEModel.load(brisque_model)
    missing = [n for n in ("niqe", "brisque") if n not in models]
    if missing:
        pristine = [a.astype(np.float64) / 255.0 for a in originals
                    if min(a.shape[:2]) >= PRISTINE_MIN_SIDE]
        if pristine:
            if "niqe" in missing:
                models["niqe"] = NIQEModel.fit_pristine(pristine)
            if "brisque" in missing:
                models["brisque"] = BRISQUEModel.fit_pristine(pristine)
            print(f"fitted pristine {missing} models from "
                  f"{len(pristine)} domain originals")
        else:
            print(f"WARNING: no images >={PRISTINE_MIN_SIDE}px to fit "
                  f"{missing}; skipping")
    return models


def eval_image(model, arr: np.ndarray, stream, steps: int, fns: dict,
               models: dict, draws: Iterable[dict]):
    """One uint8 [H, W, 3] image: coded to `stream`, decoded from it, and
    relay-sampled once for each of `draws` (decode_pipeline's noise
    keywords); the draw with the lowest LPIPS against `arr` is kept.
    Returns (its row: bpp, each of `fns`, each of `models`; its image,
    uint8 and cropped; the kept draw's index)."""
    H, W = arr.shape[:2]
    device = model.codec().device
    img01 = torch.from_numpy(to_float01(pad(arr, 64))[None]).to(device)
    model.apply_condition_compress(img01, str(stream), img01.shape[1],
                                   img01.shape[2])
    bpp = Path(stream).stat().st_size * 8 / (H * W)
    c_latent, guide_hint = model.apply_condition_decompress(str(stream))
    best = None
    for i, noise in enumerate(draws):
        out = model.decode_pipeline(c_latent, guide_hint, steps, **noise)
        recon = to_uint8(out[0].cpu().numpy())[:H, :W]
        lp = score_images({"lpips": fns["lpips"]}, arr, recon, device)["lpips"]
        if best is None or lp < best[0]:
            best = (lp, recon, i)
    _, recon, pick = best
    row = {"bpp": bpp, **score_images(fns, arr, recon, device)}
    for name, m in models.items():
        try:
            row[name] = m.score(recon.astype(np.float64) / 255.0)
        except ValueError:  # an image under NIQE's patch
            row[name] = float("nan")
    return row, recon, pick


def eval_domain(args, model, fns: dict, input_path: str, domain: str,
                noise: Callable[[], dict]) -> list:
    """Evaluate one OOD domain (`args`: the CLI's); `noise()` gives each
    test-time draw's decode_pipeline keywords. Returns its rows."""
    files = domain_files(input_path, args.num_images)
    models = {}
    if args.nr_metrics:
        models = nr_models(args.niqe_model, args.brisque_model,
                           (read_rgb(f) for f in files[:PRISTINE_IMAGES]))
    out_dir = Path(args.output) / domain
    (out_dir / "bitstreams").mkdir(parents=True, exist_ok=True)
    rows = []
    for f in files:
        name = Path(f).stem
        draws = [noise() for _ in range(max(1, args.tta_samples))]
        row, recon, _ = eval_image(
            model, read_rgb(f), out_dir / "bitstreams" / f"{name}.rdeic",
            args.steps, fns, models, draws)
        (out_dir / f"{name}.png").write_bytes(encode_png(recon))
        row = {"name": name, "domain": domain, **row}
        rows.append(row)
        print(row)
    if rows:
        write_csv(out_dir / "ood_metrics.csv", rows)
        avg = {k: float(np.nanmean([r[k] for r in rows]))
               for k in rows[0] if k not in ("name", "domain")}
        print(f"domain={domain} averages: {avg}")
    return rows


def domain_summary(names: list, all_rows: list) -> list[str]:
    """Each domain's `metric=mean±std` line (NaN-skipping)."""
    keys = [k for k in all_rows[0] if k not in ("name", "domain")]
    lines = []
    for domain in names:
        drows = [r for r in all_rows if r["domain"] == domain]
        if not drows:
            continue
        parts = []
        for k in keys:
            vals = np.asarray([r[k] for r in drows], np.float64)
            parts.append(f"{k}={np.nanmean(vals):.4f}±{np.nanstd(vals):.4f}")
        lines.append(f"  {domain} (n={len(drows)}): " + "  ".join(parts))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--config", type=str, default="configs/model/rdeic.yaml")
    ap.add_argument("--input", type=str, required=True,
                    help="comma-separated image dirs or .list files, one "
                         "per OOD domain")
    ap.add_argument("--domain", type=str, default=None,
                    help="comma-separated domain names; default: the stem "
                         "of each --input entry")
    ap.add_argument("--output", type=str, default="./ood_out")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--num_images", type=int, default=0)
    ap.add_argument("--tta_samples", type=int, default=1,
                    help=">1 enables noise-draw test-time augmentation: "
                         "keep the sample with the best LPIPS")
    ap.add_argument("--seed", type=int, default=231)
    ap.add_argument("--nr_metrics", action="store_true",
                    help="also compute no-reference NIQE + BRISQUE columns")
    ap.add_argument("--niqe_model", type=str, default=None,
                    help="fitted NIQE pristine model .npz; default: fit "
                         "from the input originals of this domain")
    ap.add_argument("--brisque_model", type=str, default=None,
                    help="fitted BRISQUE pristine model .npz; default: fit "
                         "from the input originals of this domain")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = load_model(args.config, args.ckpt, device)
    suite = MetricSuite()
    fns = {n: suite.create_metric(n) for n in METRICS}

    inputs = [s.strip() for s in args.input.split(",") if s.strip()]
    names = ([s.strip() for s in args.domain.split(",")] if args.domain
             else [Path(s).stem or "ood" for s in inputs])
    if len(names) != len(inputs):
        raise SystemExit("--domain count must match --input count")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    all_rows = []
    for inp, domain in zip(inputs, names):
        all_rows.extend(eval_domain(args, model, fns, inp, domain,
                                    lambda: {"generator": generator}))

    if all_rows and len(inputs) > 1:
        write_csv(Path(args.output) / "ood_results_all.csv", all_rows)
        print("\n=== Summary by domain (mean / std) ===")
        print("\n".join(domain_summary(names, all_rows)))


if __name__ == "__main__":
    main()
