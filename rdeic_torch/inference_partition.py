"""Batched multi-image serving CLI (counterpart of the root
inference_partition.py).

    python -m rdeic_torch.inference_partition --ckpt params.npz \
        --config configs/model/rdeic.yaml --input photos/ --output out \
        [--batch_size 4] [--micro_batch_size 2] [--bf16] [--max_size 1024]

Images are grouped by their size padded to a multiple of 64 ("partition":
batching by resolution, not spatial tiling), and each group is cut into
chunks of `--batch_size`. A chunk's codec stage codes its images in one run
of the passes, to one stream file each (`out/bitstreams/<name>.rdeic`, each
the file the single-image CLI writes), and decodes them back from those
files; it runs in a worker thread one chunk ahead, while the main thread
relay-samples the chunk before in micro-batches of `--micro_batch_size`
(0: the whole chunk), noise drawn from one `torch.Generator` seeded with
`--seed`. Reconstructions are cropped, resized back to the input's size when
`--max_size` shrank it (PIL LANCZOS), and saved as `out/<name>.png`;
`out/metrics.csv` has a row per image (name, bpp of the file over the
input's size, psnr, ms_ssim (NaN under 176 px a side), lpips (random
weights: comparisons only), seconds per image of its chunk, caption) and an
`averages:` line is printed.

The numerics flags of `utils.backend.full_fp32` belong to the process, not
to a thread, so the whole serving loop runs inside one deterministic fp32
scope: the codec in its thread and the sampler in the main thread see the
same flags throughout, and the streams are the bytes a serial run writes.

`--use_captions` captions each image with a local Hugging Face VLM
(`--caption_model`, no download) and conditions the sampler on its CLIP
context, when `--bpe_vocab` names the merges file and the weights have a
CLIP tower; without the VLM every prompt is empty. Runs on CUDA unless
`--device cpu`.

`--dp N` serves over a mesh of the first N devices (`make_mesh(dp, 1,
devices[:dp])`, so N above the device count raises, as the root CLI
does; with `--device cpu` the N devices are copies of the CPU), a model
replica on each: each micro-batch's noise is drawn at the micro-batch's
size on the first device, as at `--dp 1`, its rows split in dp blocks
over the replicas, one thread a device (`pipeline.rdeic.decode_rows`),
and the images gathered in row order. `--micro_batch_size` must divide by
N; a chunk's ragged tail micro-batch runs on the first device alone. The
codec stage stays on the first device, so the streams are those of
`--dp 1`.

The per-chunk work (`codec_stage`, `sample_stage`, `serve`) takes arrays,
so it runs where no image library is installed; only `main` reads and
writes images.
"""
from __future__ import annotations

import argparse
import csv
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from rdeic_torch.inference import list_images, load_model
from rdeic_torch.parallel.mesh import make_mesh
from rdeic_torch.pipeline.rdeic import decode_rows
from rdeic_torch.utils.backend import full_fp32, resolve_device
from rdeic_torch.utils.image import pad, to_float01, to_uint8
from rdeic_torch.utils.metrics import MetricSuite


def generate_captions(files, model_id: str) -> dict:
    """Caption images with a Hugging Face VLM (Qwen2-VL in the reference),
    from local files only; on any failure every prompt is empty."""
    try:
        from transformers import (  # noqa: PLC0415
            AutoProcessor,
            Qwen2VLForConditionalGeneration,
        )

        proc = AutoProcessor.from_pretrained(model_id, local_files_only=True)
        vlm = Qwen2VLForConditionalGeneration.from_pretrained(
            model_id, local_files_only=True)
    except Exception as e:  # noqa: BLE001 (any failure: empty prompts)
        print(f"[captioning unavailable: {e}; using empty prompts]")
        return {f: "" for f in files}
    from PIL import Image  # noqa: PLC0415

    captions = {}
    for f in files:
        img = Image.open(f).convert("RGB")
        msgs = [{"role": "user", "content": [
            {"type": "image"},
            {"type": "text", "text": "Describe this image in one sentence."},
        ]}]
        prompt = proc.apply_chat_template(msgs, add_generation_prompt=True)
        inputs = proc(text=[prompt], images=[img], return_tensors="pt")
        out = vlm.generate(**inputs, max_new_tokens=48)
        captions[f] = proc.batch_decode(out[:, inputs["input_ids"].shape[1]:],
                                        skip_special_tokens=True)[0].strip()
    return captions


def make_chunks(items, batch_size: int) -> list[list[tuple[str, np.ndarray]]]:
    """(name, padded uint8 HWC) items -> chunks of at most `batch_size`
    images of one padded size, groups in the order their first image
    comes."""
    groups = defaultdict(list)
    for name, padded in items:
        groups[padded.shape[:2]].append((name, padded))
    chunks = []
    for (h, w), group in groups.items():
        print(f"group {h}x{w}: {len(group)} images")
        chunks += [group[i:i + batch_size]
                   for i in range(0, len(group), batch_size)]
    return chunks


def stream_path(stream_dir: Path, name: str) -> Path:
    return Path(stream_dir) / f"{Path(name).stem}.rdeic"


def codec_stage(model, chunk, stream_dir: Path):
    """A chunk's images to one stream file each in one run of the passes,
    then back from those files: (bpps over the padded size, c_latent,
    guide_hint)."""
    device = model.uncond_context.device
    imgs01 = torch.from_numpy(
        np.stack([to_float01(p) for _, p in chunk])).to(device)
    streams = [stream_path(stream_dir, name) for name, _ in chunk]
    bpps = model.apply_condition_compress_batch(imgs01, streams)
    c_latent, guide_hint = model.apply_condition_decompress_batch(streams)
    return bpps, c_latent, guide_hint


def oom_advice(micro: int, batch_size: int) -> str:
    return ("\nOUT OF DEVICE MEMORY during sampling. Try, in order:\n"
            f"  --micro_batch_size {max(1, micro // 2)} "
            "(halve the sampling micro-batch)\n"
            "  --bf16 (halves activation memory)\n"
            f"  --batch_size {max(1, batch_size // 2)} "
            "(halve the codec batch)\n"
            "  --max_size 1024 (resize guard for very large images)\n"
            "  or tiled serving for 2K+ images (bounded memory at any "
            "resolution).")


def sample_stage(model, c_latent, guide_hint, *, steps: int, micro: int,
                 generator: torch.Generator, sampler: str = "ddpm",
                 guidance_scale: float = 1.0,
                 context: Optional[torch.Tensor] = None,
                 batch_size: Optional[int] = None,
                 replicas: Sequence = ()) -> torch.Tensor:
    """Relay sampling and VAE decode of a chunk in micro-batches of `micro`
    (the last may be smaller), each `decode_pipeline` drawing its noise
    from `generator` in turn: [B, H, W, 3] in [0, 1]. With `replicas` (the
    model on each device of a dp mesh, `model` first), a micro-batch that
    divides by their count draws its noise first and is split over them
    (`decode_rows`); one that does not runs on `model` alone."""
    dp = max(len(replicas), 1)
    outs = []
    for j in range(0, c_latent.shape[0], micro):
        cl, gh = c_latent[j:j + micro], guide_hint[j:j + micro]
        ctx = None if context is None else context[j:j + micro]
        opts = dict(sampler=sampler, guidance_scale=guidance_scale,
                    context=ctx)
        try:
            if dp > 1 and cl.shape[0] % dp == 0:
                noise = model.sample_noise(cl, steps, sampler, generator)
                outs.append(decode_rows(replicas, cl, gh, steps, noise=noise,
                                        **opts))
                continue
            if dp > 1:
                print(f"[dp] tail micro-batch of {cl.shape[0]} not divisible "
                      f"by --dp {dp}: running unsharded on one device",
                      flush=True)
            outs.append(model.decode_pipeline(cl, gh, steps, **opts,
                                              generator=generator))
        except torch.cuda.OutOfMemoryError:
            print(oom_advice(micro, batch_size or c_latent.shape[0]))
            raise
    return torch.cat(outs)


def serve(model, chunks, stream_dir: Path, *, steps: int, micro: int,
          generator: torch.Generator, sampler: str = "ddpm",
          guidance_scale: float = 1.0,
          context_fn: Optional[Callable] = None,
          batch_size: Optional[int] = None,
          replicas: Sequence = ()) -> Iterator[tuple]:
    """Each chunk's (chunk, reconstructions [B, H, W, 3] in [0, 1] on the
    host, bpps, seconds per image): the codec stage of chunk k + 1 runs in
    a worker thread while chunk k samples (over `replicas` when given, see
    `sample_stage`). `context_fn(chunk)` gives the chunk's context (None:
    the stored empty prompt). The loop holds one deterministic fp32 scope,
    so every thread sees the same numerics flags from the first chunk to
    the last."""
    with full_fp32(deterministic=True), ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(codec_stage, model, chunks[0], stream_dir) if chunks else None
        for ci, chunk in enumerate(chunks):
            t0 = time.time()
            bpps, c_latent, guide_hint = fut.result()
            fut = (pool.submit(codec_stage, model, chunks[ci + 1], stream_dir)
                   if ci + 1 < len(chunks) else None)
            context = context_fn(chunk) if context_fn is not None else None
            out = sample_stage(model, c_latent, guide_hint, steps=steps,
                               micro=micro, generator=generator,
                               sampler=sampler, guidance_scale=guidance_scale,
                               context=context, batch_size=batch_size,
                               replicas=replicas)
            out = out.float().cpu().numpy()
            yield chunk, out, bpps, (time.time() - t0) / len(chunk)


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
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--micro_batch_size", type=int, default=0,
                    help="sampling micro-batch (0 = batch_size)")
    ap.add_argument("--guidance_scale", type=float, default=1.0)
    ap.add_argument("--use_captions", action="store_true")
    ap.add_argument("--caption_model", default="Qwen/Qwen2-VL-2B-Instruct")
    ap.add_argument("--bpe_vocab", default=None,
                    help="CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz); "
                         "required to embed captions")
    ap.add_argument("--bf16", action="store_true",
                    help="serve the VAE and the denoiser in bf16")
    ap.add_argument("--max_size", type=int, default=0,
                    help="resize guard: downscale the long side to this "
                         "before coding, upsample the reconstruction back "
                         "(0 = off)")
    ap.add_argument("--seed", type=int, default=231)
    ap.add_argument("--profile_memory", action="store_true")
    ap.add_argument("--dp", type=int, default=1,
                    help="devices to shard each micro-batch over")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    micro = args.micro_batch_size or args.batch_size
    if micro % args.dp:
        raise ValueError(f"--micro_batch_size {micro} must divide by --dp "
                         f"{args.dp}")

    from PIL import Image  # noqa: PLC0415 (only the CLI reads images)

    device = resolve_device(args.device)

    def load(dev: torch.device):
        m = load_model(args.config, args.ckpt, dev)
        if args.bf16:
            m.set_compute_dtype(torch.bfloat16)
        return m

    model = load(device)
    replicas = []
    if args.dp > 1:
        devices = ([device] * args.dp if device.type == "cpu" else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
        mesh = make_mesh(dp=args.dp, tp=1, devices=devices[:args.dp])
        home = model.uncond_context.device
        replicas = [model if dev == home else load(dev)
                    for dev in mesh.devices()]
        print(f"serving mesh: dp={args.dp} over {len(devices)} devices")
    metrics = MetricSuite()
    psnr_f = metrics.create_metric("psnr")
    msssim_f = metrics.create_metric("ms_ssim")
    lpips_f = metrics.create_metric("lpips")

    files = list_images(Path(args.input))
    out_dir = Path(args.output)
    stream_dir = out_dir / "bitstreams"
    stream_dir.mkdir(parents=True, exist_ok=True)

    # captioning (host) overlaps with coding: it starts in its own thread
    # and is waited for at the first tokenization or the first CSV row
    captions = {f: "" for f in files}
    captions_future = None
    if args.use_captions:
        captions_future = ThreadPoolExecutor(max_workers=1).submit(
            generate_captions, files, args.caption_model)
    tokenizer = None
    if args.use_captions and args.bpe_vocab and hasattr(model, "clip"):
        from rdeic_torch.models.clip import SimpleTokenizer  # noqa: PLC0415

        tokenizer = SimpleTokenizer(args.bpe_vocab)

    def resolve_captions() -> None:
        nonlocal captions, captions_future
        if captions_future is not None:
            captions = captions_future.result()
            captions_future = None

    def context_fn(chunk):
        resolve_captions()
        tokens = tokenizer.tokenize([captions.get(f, "") for f, _ in chunk])
        return model.get_learned_conditioning(
            len(chunk), torch.from_numpy(tokens).to(device))

    items, originals = [], {}
    for f in files:
        arr = np.array(Image.open(f).convert("RGB"))
        small = arr
        if args.max_size and max(arr.shape[:2]) > args.max_size:
            scale = args.max_size / max(arr.shape[:2])
            nh, nw = int(arr.shape[0] * scale), int(arr.shape[1] * scale)
            small = np.array(Image.fromarray(arr).resize((nw, nh),
                                                         Image.LANCZOS))
        originals[f] = (arr, small.shape[:2])
        items.append((f, pad(small, 64)))
    chunks = make_chunks(items, args.batch_size)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    rows = []
    for chunk, out, bpps, dt in serve(
            model, chunks, stream_dir, steps=args.steps, micro=micro,
            generator=generator, sampler=args.sampler,
            guidance_scale=args.guidance_scale,
            context_fn=context_fn if tokenizer is not None else None,
            batch_size=args.batch_size, replicas=replicas):
        if args.profile_memory and device.type == "cuda":
            print(f"  device mem: {torch.cuda.memory_allocated() / 2**20:.0f} MiB")
        resolve_captions()  # the captions go in the CSV
        for (f, _), recon01 in zip(chunk, out):
            arr, (sh, sw) = originals[f]
            recon = to_uint8(recon01)[:sh, :sw]
            if recon.shape[:2] != arr.shape[:2]:
                recon = np.array(Image.fromarray(recon).resize(
                    (arr.shape[1], arr.shape[0]), Image.LANCZOS))
            name = Path(f).stem
            Image.fromarray(recon).save(out_dir / f"{name}.png")
            a, b = (torch.from_numpy(x.astype(np.float32) / 255.0)[None].to(device)
                    for x in (arr, recon))
            size = stream_path(stream_dir, f).stat().st_size
            row = dict(
                name=name, bpp=size * 8 / (arr.shape[0] * arr.shape[1]),
                psnr=float(psnr_f(a, b)[0]),
                ms_ssim=(float(msssim_f(a, b)[0])
                         if min(arr.shape[:2]) >= 176 else float("nan")),
                lpips=float(lpips_f(a, b)[0]),
                time=dt, caption=captions.get(f, ""))
            rows.append(row)
            print(f"  {name}: bpp={row['bpp']:.5f} psnr={row['psnr']:.2f} "
                  f"time={dt:.2f}s")

    with (out_dir / "metrics.csv").open("w", newline="") as fcsv:
        writer = csv.DictWriter(fcsv, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    avg = {k: float(np.nanmean([r[k] for r in rows]))
           for k in ("bpp", "psnr", "ms_ssim", "lpips", "time")}
    print("averages:", ", ".join(f"{k}={v:.4f}" for k, v in avg.items()))


if __name__ == "__main__":
    main()
