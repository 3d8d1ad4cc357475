"""Single-image encode -> bitstream -> decode CLI (counterpart of the root
inference.py).

    python -m rdeic_torch.inference --ckpt params.npz \
        --config configs/model/rdeic.yaml --input photos/ --output out

Each image is padded to a multiple of 64, coded to
`out/bitstreams/<name>.rdeic`, decoded back from that file, relay-sampled,
cropped and saved as `out/<name>.png`; one `name: bpp=... time=...` line per
image. `--ckpt` is a flat `.npz` of JAX params (rdeic_tpu's
`save_params_npz`). Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from rdeic_torch.data.dataset import list_image_files
from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.convert import load_npz_weights
from rdeic_torch.utils.image import pad, to_float01, to_uint8


def process(model, img01: torch.Tensor, steps: int, stream_path: str,
            generator: torch.Generator):
    """Compress one padded image to a file and decode it back. Returns
    (reconstruction uint8 HWC, bpp over the padded size)."""
    h, w = img01.shape[1:3]
    bpp = model.apply_condition_compress(img01, stream_path, h, w)
    c_latent, guide_hint = model.apply_condition_decompress(stream_path)
    out = model.decode_pipeline(c_latent, guide_hint, steps, generator=generator)
    return to_uint8(out[0].cpu().numpy()), bpp


def load_model(config: str, ckpt: str, device: torch.device):
    if not str(ckpt).endswith(".npz"):
        raise NotImplementedError(
            f"{ckpt}: only flat .npz params load here; orbax train-state "
            "checkpoints have no counterpart (ROADMAP Queue 1, the rest)")
    model = instantiate_from_config(load_yaml(config), device=device)
    load_npz_weights(model, ckpt)
    return model.eval()


def list_images(path: Path) -> list[str]:
    """A file as it is; a directory's images at any depth, in the order of
    the reference CLI (`list_image_files`)."""
    if path.is_file():
        return [str(path)]
    return list_image_files(str(path))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True, help="flat .npz of JAX params")
    ap.add_argument("--config", default="configs/model/rdeic.yaml")
    ap.add_argument("--input", required=True, help="image file or dir")
    ap.add_argument("--output", required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"])
    ap.add_argument("--guidance_scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=231)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sampler != "ddpm":
        raise NotImplementedError(
            "--sampler ddim: ROADMAP Queue 1, DDIM and CFG")
    if args.guidance_scale != 1.0:
        raise NotImplementedError(
            "--guidance_scale: ROADMAP Queue 1, DDIM and CFG")
    if args.bf16:
        raise NotImplementedError("--bf16: ROADMAP Queue 1, bf16")

    from PIL import Image  # noqa: PLC0415 (only the CLI reads images)

    device = resolve_device(args.device)
    model = load_model(args.config, args.ckpt, device)
    out_dir = Path(args.output)
    (out_dir / "bitstreams").mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    bpps, times = [], []
    for fp in list_images(Path(args.input)):
        name = Path(fp).stem
        arr = np.array(Image.open(fp).convert("RGB"))
        H, W = arr.shape[:2]
        img01 = torch.from_numpy(to_float01(pad(arr, 64))[None]).to(device)
        stream = out_dir / "bitstreams" / f"{name}.rdeic"
        t0 = time.time()
        recon, _ = process(model, img01, args.steps, str(stream), generator)
        dt = time.time() - t0
        Image.fromarray(recon[:H, :W]).save(out_dir / f"{name}.png")
        bpp = stream.stat().st_size * 8 / (H * W)
        bpps.append(bpp)
        times.append(dt)
        print(f"{name}: bpp={bpp:.5f} time={dt:.2f}s")
    if bpps:
        print(f"avg bpp={np.mean(bpps):.5f} avg time={np.mean(times):.2f}s")


if __name__ == "__main__":
    main()
