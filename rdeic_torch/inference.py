"""Single-image encode -> bitstream -> decode CLI (counterpart of the root
inference.py).

    python -m rdeic_torch.inference --ckpt params.npz \
        --config configs/model/rdeic.yaml --input photos/ --output out \
        [--sampler ddpm|ddim] [--guidance_scale 1.0] [--bf16]

Each image is padded to a multiple of 64, coded to
`out/bitstreams/<name>.rdeic`, decoded back from that file, relay-sampled
(spaced DDPM or DDIM; classifier-free guidance when `--guidance_scale` is not
1), cropped and saved as `out/<name>.png`; one `name: bpp=... time=...` line
per image. `--bf16` serves the VAE and the denoiser in bf16: they compute in
bf16 and their weights are stored in bf16 (`RDEIC.set_compute_dtype` with
its `cast_weights`); the compression model and the stream stay fp32. `--show_lq` is accepted and unused, as in
the root CLI. `--ckpt` is a flat `.npz` of JAX params (rdeic_tpu's
`save_params_npz`), a `step_N.pt` train state that `python -m
rdeic_torch.train` wrote, or its `checkpoints` directory (the largest N
wins); an orbax checkpoint of the JAX package is refused (ROADMAP Queue 1,
the rest). Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from rdeic_torch.data.dataset import list_image_files
from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.train.trainer import latest_checkpoint
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.convert import load_npz_weights, load_train_state_weights
from rdeic_torch.utils.image import pad, to_float01, to_uint8


def process(model, img01: torch.Tensor, steps: int, stream_path: str,
            generator: torch.Generator, sampler: str = "ddpm",
            guidance_scale: float = 1.0):
    """Compress one padded image to a file and decode it back. Returns
    (reconstruction uint8 HWC, bpp over the padded size)."""
    h, w = img01.shape[1:3]
    bpp = model.apply_condition_compress(img01, stream_path, h, w)
    c_latent, guide_hint = model.apply_condition_decompress(stream_path)
    out = model.decode_pipeline(c_latent, guide_hint, steps, sampler=sampler,
                                guidance_scale=guidance_scale,
                                generator=generator)
    return to_uint8(out[0].cpu().numpy()), bpp


def load_model(config: str, ckpt: str, device: torch.device):
    """The model of `config` with the weights of `ckpt`: a flat `.npz` of
    JAX params, a `Trainer.save` file, or a directory of `step_N.pt` files
    (the largest N)."""
    npz = str(ckpt).endswith(".npz")
    state = None if npz else latest_checkpoint(ckpt)  # refuses before the build
    model = instantiate_from_config(load_yaml(config), device=device)
    if npz:
        load_npz_weights(model, ckpt)
    else:
        load_train_state_weights(model, state)
    return model.eval()


def list_images(path: Path) -> list[str]:
    """A file as it is; a directory's images at any depth, in the order of
    the reference CLI (`list_image_files`)."""
    if path.is_file():
        return [str(path)]
    return list_image_files(str(path))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="flat .npz of JAX params, a step_N.pt train state, "
                         "or a directory of them (the latest step)")
    ap.add_argument("--config", default="configs/model/rdeic.yaml")
    ap.add_argument("--input", required=True, help="image file or dir")
    ap.add_argument("--output", required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"])
    ap.add_argument("--guidance_scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=231)
    ap.add_argument("--show_lq", action="store_true",
                    help="accepted, unused (as in the root CLI)")
    ap.add_argument("--bf16", action="store_true",
                    help="serve the VAE and the denoiser in bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image  # noqa: PLC0415 (only the CLI reads images)

    device = resolve_device(args.device)
    model = load_model(args.config, args.ckpt, device)
    if args.bf16:
        model.set_compute_dtype(torch.bfloat16)
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
        recon, _ = process(model, img01, args.steps, str(stream), generator,
                           args.sampler, args.guidance_scale)
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
