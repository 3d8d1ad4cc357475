"""Drive rdeic_torch on one NVIDIA GPU and check every kernel it runs.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (for the flash-attention and GroupNorm forward
kernels), triton (for the GroupNorm backward) and g++; no network. Phases,
each fatal on failure:

1. environment: torch / CUDA / triton versions and the card's name and power
   limit (nvidia-smi);
2. build: nvcc (forward and backward flash kernels, GroupNorm forward) and
   g++ start together on the sources in the checkout; ptxas's registers and
   spills of each CUDA kernel are logged by name, and a tensor-core flash
   kernel (d = 64, d = 512) that spills fails the run;
3. main path at the full width of configs/model/rdeic.yaml (random weights
   from --seed): the CLI's per-image `rdeic_torch.inference.process` codes a
   synthetic 768x512 image to a stream file, decodes it back, relay-samples
   it in 2 DDPM steps and decodes it with the VAE. It runs once to warm up
   (Triton compiles, cuDNN plans), then once, timed, with every kernel's
   launch count set to 0. A third, uncounted run makes the same three
   pipeline calls one by one, timed per stage. Checks: the stream is the
   same every time; process() gives the same image both times, equal to the
   staged run's; the staged image is 512x768x3 and finite; the decoded
   (c_latent, guide_hint) equal the encoder's synthesis bit for bit; each
   kernel ran as often as the model's structure says;
4. reference on a small input: a 256x256 image through the same weights,
   once on the card (kernels) and once on the CPU (plain versions), from the
   same latents and noise;
5. training reference: one independent-phase micro-step (B = 1, 256x256) of
   the same weights on the card and on the CPU, from the same noise: the
   loss and every trainable gradient agree within a relative limit that a
   planted 1.05x fault must read outside of, the CPU run taking the card's
   value at each convolution output of the compression model after
   checking it (see TRAIN_REF_TOL);
6. independent-phase training at the full width, with `use_checkpoint` as
   in the model YAML and the lr and accumulation of configs/train_rdeic.yaml:
   a `rdeic_torch.train.trainer.Trainer` takes one warm-up micro-step on
   synthetic B = 2, 512x512 images, then 4 timed micro-steps (one AdamW
   update) with every launch count set to 0. Checks: finite loss and
   gradient norm; the frozen base UNet, VAE and uncond_context bit-equal
   after the update; every trainable tensor with a nonzero gradient moved;
   the codebook usage moved; each kernel ran as often as the structure says;
7. refine-phase training reference: as 5, for one refine micro-step (B =
   1, 256x256; gradients through both sampler steps, the VAE decoder, whose
   attention at L = 1024 runs the d = 512 backward kernels, and LPIPS);
8. refine-phase training at the full width: the same weights (shared, not
   copied) in an `is_refine` model with LPIPS(alex) on random weights (the
   published ones are not in the repository), the lr and accumulation of
   configs/train_rdeic_refine_v5e.yaml and the batch of
   configs/dataset/lic_train_refine_v5e.yaml, fp32 with `use_checkpoint` as
   the model YAML sets it (denoiser on, VAE decoder off): one warm-up
   micro-step on synthetic B = 2, 512x512 images, then 3 timed ones with
   every launch count set to 0, each applying AdamW. Checks as in 6, LPIPS
   among the frozen tensors;
9. kernels against their plain versions at every shape of the serving and
   the training paths, and at shapes on no path (their rows carry no
   calls): flash at d = 512 and d = 64 with B = 2, H > 1 and L = 1000, and
   at d = 64 with L = 8192 (the CHECK_SHAPES), GroupNorm at a span larger than a cluster's shared memory
   (GN_STREAM_KEYS: the kernel's streaming variant), in fp32 and bf16, with
   the kernel, plain and library times (CUDA events) and the bound of each.
   `ms` times launches back to back, so a launch-bound call reads its host
   time; `device_ms` (and `library_device_ms`) times the same launches
   queued behind a sleeping kernel, so it reads the card's time alone
   (device_ms); GroupNorm rows add the host µs a call takes to enqueue.
   A flash row's bound takes the rate named in its `bound_rate`
   (flash_rate): for fp32, the TF32 tensor cores over the three passes of
   3xTF32 where the kernel runs them (every d = 64 and d = 512 kernel) and
   fp32 FMA at d = 16; for bf16, the card's bf16 peak. Each comparison also
   reads a planted fault (the kernel's output scaled by 1.05) and fails if
   that reading is within the limit.

The last two lines of stdout are the kernel summary
`{"kernels": [...]}` and `{"ok": true, "device": {...}}`. `ms`, `plain_ms`,
`bound_ms` and `library_ms` of a kernel are summed over its calls in one
run of the path its `path` names: per image for the serving kernels
(flash_attn_fwd, group_norm_silu_fwd), per refine micro-step for the
others (`ms_by_path` also gives the kernel time per independent-phase
micro-step); `shapes` has the per-call numbers and the calls in each path.
`launches` counts kernel launches in that path's counted run (one per flash
call and per GroupNorm forward call; two per GroupNorm backward call:
moments then dx), `launches_by_path` in each path's. The plain and library times of
flash_attn_bwd_dq and flash_attn_bwd_dkv are each of a whole backward (dq,
dk and dv): compare them with the sum of the two kernels, and so is their
`backward_bound_ms` (10 B H L^2 d flops: S, dP, dV, dQ, dK once each);
each kernel's own `bound_ms` counts the S and dP it recomputes.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from rdeic_torch import build
from rdeic_torch.inference import process
from rdeic_torch.models.blocks import Conv, GroupNorm32
from rdeic_torch.models.lpips import LPIPS
from rdeic_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_lse,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from rdeic_torch.ops.fused_groupnorm import (
    group_norm,
    group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_fwd,
    group_norm_plain,
)
from rdeic_torch.pipeline.rdeic import RDEIC
from rdeic_torch.train.trainer import Trainer, trainable_parameters
from rdeic_torch.utils.backend import full_fp32, resolve_device
from rdeic_torch.utils.image import to_uint8

# configs/model/rdeic.yaml `params` (the card's machine has no yaml module;
# tests/test_torch_port_isolation.py holds this dict equal to the file)
MODEL_CONFIG = {
    "linear_start": 0.00085, "linear_end": 0.012, "timesteps": 1000,
    "scale_factor": 0.18215, "parameterization": "eps",
    "sync_path": None, "synch_control": False, "ckpt_path_pre": None,
    "sd_locked": True, "is_refine": False, "fixed_step": 2,
    "used_timesteps": 300, "learning_rate": 2.0e-5, "l_guide_weight": 2.0,
    "l_bpp_weight": 1.0,
    "control_stage_config": {
        "target": "rdeic_tpu.models.control.NoiseEstimatorConfig",
        "params": {
            "use_checkpoint": True, "in_channels": 4, "out_channels": 4,
            "hint_channels": 256, "model_channels": 320,
            "attention_resolutions": [4, 2, 1], "num_res_blocks": 2,
            "channel_mult": [1, 2, 4, 4], "num_head_channels": 16,
            "context_dim": 1024, "control_model_ratio": 0.2,
            "control_scale": 1.0}},
    "unet_config": {
        "target": "rdeic_tpu.models.unet.UNetConfig",
        "params": {
            "in_channels": 4, "out_channels": 4, "model_channels": 320,
            "attention_resolutions": [4, 2, 1], "num_res_blocks": 2,
            "channel_mult": [1, 2, 4, 4], "num_head_channels": 64,
            "context_dim": 1024}},
    "first_stage_config": {
        "target": "rdeic_tpu.models.vae.AutoencoderKLConfig",
        "params": {
            "embed_dim": 4,
            "ddconfig": {"double_z": True, "z_channels": 4, "in_channels": 3,
                         "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4],
                         "num_res_blocks": 2}}},
    "cond_stage_config": {
        "target": "rdeic_tpu.models.clip.OpenCLIPTextConfig",
        "params": {"freeze": True, "layer": "penultimate"}},
    "preprocess_config": {
        "target": "rdeic_tpu.models.compression.CompressionConfig",
        "params": {
            "in_nc": 512, "out_nc": 4, "N": 256, "M": 256, "slice_num": 10,
            "slice_ch": [8, 8, 8, 8, 16, 16, 32, 32, 64, 64],
            "codebook_size": 16384}},
    "calculate_metrics": {
        "psnr": {"type": "psnr", "crop_border": 0, "test_y_channel": False},
        "ms_ssim": {"type": "ms_ssim", "test_y_channel": False},
        "lpips": {"type": "lpips", "better": "lower"}},
}

# configs/train_rdeic.yaml `trainer` and configs/dataset/lic_train.yaml
# (tests/test_torch_port_isolation.py holds these equal to the files)
TRAIN_CONFIG = {"learning_rate": 2.0e-5, "accumulate_grad_batches": 4,
                "batch_size": 2, "out_size": 512}
# configs/train_rdeic_refine_v5e.yaml `trainer` and
# configs/dataset/lic_train_refine_v5e.yaml (held equal to the files as
# above); the model is MODEL_CONFIG with is_refine. That YAML's
# compute_dtype / frozen_dtype bfloat16, fast_init and remat_policy "dots"
# are not ported (the compute stays fp32, use_checkpoint as the model YAML)
REFINE_CONFIG = {"learning_rate": 2.0e-5, "accumulate_grad_batches": 1,
                 "batch_size": 2, "out_size": 512}
REFINE_MODEL_CONFIG = {**MODEL_CONFIG, "is_refine": True}

IMAGE_HW = (512, 768)  # a Kodak-sized image, landscape
STEPS = 2
TRAIN_STEPS = 4  # timed micro-steps after one warm-up: one AdamW update
REFINE_STEPS = 3  # timed refine micro-steps after one warm-up, each updating
# self-attentions over >= 1024 tokens per dual-UNet call at 512x512 (UNet
# L = 4096 h5 d64 x5 and L = 1024 h10 d64 x5, control L = 4096 h4 d16 x2 and
# L = 1024 h8 d16 x2; L = 256 goes to the plain product)
FLASH_PER_DENOISER_CALL_512 = 14
# card vs CPU training reference: max |g_card - g_cpu| of each trainable
# tensor over max |g_cpu| of that tensor, or over TRAIN_REF_FLOOR x the
# largest gradient where the tensor's own gradient is zero but for rounding
# (a bias right before a GroupNorm, which removes the channel mean). The
# compression model's forward has kinks (LeakyReLU's slope at 0, the
# rounding of y - mu, lower_bound's gradient rule, the codebook's argmax)
# and weights the rate term by 1 / likelihood, so a forward rounding
# difference of ~1e-7 moves its gradients by up to ~1e-2 between two correct
# runs. The CPU run therefore takes the card's value at every convolution
# output of the compression model (the gradient passes straight through),
# after holding each such output to TRAIN_REF_TOL["conv"]; the gradients then
# differ only by the backward's arithmetic. In the refine phase LPIPS's ReLUs
# are kinks of the same kind, on the path of every gradient: its convolution
# outputs are pinned too. A second CPU run without the
# pinning shows, in the log only, how far they move otherwise. Gradients are
# reported by group: denoiser (control branch and bridges, through every
# flash and GroupNorm backward kernel), synthesis (compression.decoder and
# .out, reached through c_latent and guide_hint) and rate (every other
# compression tensor: it carries the rate term). The rate group still reads
# up to 7e-4 with the forward pinned. No kernel of the port is on that
# path, only torch's own CUDA and CPU operators (PERF.md keeps the question
# open), so its limit is 7x the larger reading of seeds 0 and 1, a tenth of
# the planted fault's.
TRAIN_REF_TOL = {"denoiser": 1e-4, "synthesis": 1e-4, "rate": 5e-3,
                 "conv": 1e-4, "loss": 1e-5}
SYNTHESIS_PREFIXES = ("compression.decoder.", "compression.out.")
TRAIN_REF_FLOOR = 1e-5
# H100 SXM data-sheet peaks (NVIDIA; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_FLOPS = 494.7e12
# Head dims whose flash kernels run on the tensor cores in TF32, an fp32
# product as three TF32 products (3xTF32); d = 16 runs fp32 FMA
TC_HEAD_DIMS = (64, 512)
FAULT_SCALE = 1.05  # a planted output-scale error each check must see
GN_TOL = 1e-4  # fp32 GroupNorm outputs up to ~15 after scale and bias
# relative to max |plain| of each output, for the training kernels: fp32
# sums in other orders land ~1e-6 apart. A bf16 output is held to the plain
# version's unrounded fp32 result (plain on the same values upcast): rounding
# to nearest bf16 moves a value by at most half an ulp, 2^-8 of its
# magnitude, so the limit is 2^-8 plus the fp32 limit
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -8 + 1e-4}
FLASH_SHAPES = [(1, 6144, 5, 64), (1, 6144, 4, 16), (1, 6144, 1, 512),
                (1, 1536, 10, 64), (1, 1536, 8, 16)]
# flash shapes on no path: B = 2, H > 1 (every path's d = 512 shape has
# H = 1) and an L that is a multiple of no tile of the tensor-core kernels;
# and at d = 64 twice the paths' longest L, as the backward's dq, dk and dv
# sums run over L
CHECK_SHAPES = [(2, 1000, 2, 512), (2, 1000, 3, 64), (1, 8192, 2, 64)]
# a GroupNorm span on no path larger than 8 CTAs' shared memory in both
# dtypes (16 x 65536 elements), so the forward kernel streams it
GN_STREAM_KEYS = [(1, 512, 256, 256, 32, 1e-5, True, dt)
                  for dt in ("float32", "bfloat16")]
# torch.cuda._sleep counts cycles; at this clock or below (the H100's boost
# clock is 1.98 GHz) a sleep lasts at least the seconds asked
SLEEP_CLOCK_HZ = 2.0e9


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, windows: int = 2) -> tuple[float, float]:
    """(device ms a launch, host ms a call) of fn(). The host time is that of
    enqueuing `reps` calls without a sync; the device time is that of
    `reps` calls queued behind torch.cuda._sleep, which holds the stream
    until the host has enqueued them all, so the events' window holds the
    card's work and its gaps between launches, and no host time. A host
    stall longer than the sleep's margin would let host time in, and can
    only lengthen a window, so the shortest of `windows` is kept."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reads = []
    for _ in range(windows):
        torch.cuda._sleep(int(SLEEP_CLOCK_HZ * (3 * host * reps + 5e-3)))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        reads.append(start.elapsed_time(end) / reps)
    return min(reads), host * 1e3


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_environment() -> str:
    import triton  # noqa: PLC0415

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  triton {triton.__version__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] nvcc + g++ in parallel: {time.perf_counter() - t0:.1f} s")
    spills = []
    for lib in ("flash_attn_fwd", "flash_attn_bwd", "group_norm_fwd"):
        kernel = "?"
        for line in build.build_log(libs[lib]).splitlines():
            m = re.search(r"\d(flash_(?:fwd|dq|dkv)_(?:kernel|d16|d64|d512)|gn_fwd)"
                          r"I(f|13__nv_bfloat16)((?:L[ib]\d+E)*)", line)
            if "Compiling entry function" in line and m:  # a mangled name
                ints = re.findall(r"L[ib](\d+)E", m[3])  # template ints
                what, n = {"kernel": ("d", 1), "fwd": ("vec", 1)}.get(
                    m[1].rsplit("_", 1)[-1], ("", 0))
                kernel = (f"{m[1]}<{'fp32' if m[2] == 'f' else 'bf16'}"
                          + (f", {what} = {', '.join(ints[:n])}" if ints else "")
                          + ">")
            elif "registers" in line or "spill" in line:
                log(f"[build] {lib} ptxas {kernel}: {line.strip()}")
                if (re.search(r"_d(64|512)<", kernel)
                        and re.search(r"[1-9]\d* bytes spill", line)):
                    spills.append(kernel)
    if spills:
        raise AssertionError(f"tensor-core flash kernels spill: {spills}")


def make_model(device, seed: int) -> RDEIC:
    """Full-width RDEIC with random weights: conv and dense kernels LeCun
    normal, as flax initialises them (torch's default keeps the compression
    latents so small that almost every coded symbol is 0), the zero-init
    bridges included."""
    torch.manual_seed(seed)
    model = RDEIC(**MODEL_CONFIG, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight") and p.dim() > 1:
                p.normal_(0.0, p[0].numel() ** -0.5)
        model.uncond_context.normal_()
    return model.eval()


KERNEL_FNS = {
    "flash_attn_fwd": flash_attention,
    "flash_attn_fwd_lse": flash_attention_lse,
    "flash_attn_bwd_dq": flash_attention_dq,
    "flash_attn_bwd_dkv": flash_attention_dkv,
    "group_norm_silu_fwd": group_norm,
    "group_norm_silu_bwd": group_norm_bwd,
}


def reset_counters():
    for fn in KERNEL_FNS.values():
        fn.launches = 0
        fn.shapes = {}


def read_counters():
    """(launches, shapes) of every kernel wrapper since the last reset."""
    return ({k: fn.launches for k, fn in KERNEL_FNS.items()},
            {k: dict(fn.shapes) for k, fn in KERNEL_FNS.items()})


def run_process(model, img01, stream: Path, seed: int):
    """One image through the CLI's per-image function; (uint8 image, bpp)."""
    gen = torch.Generator(device=img01.device).manual_seed(seed)
    return process(model, img01, STEPS, str(stream), gen)


def run_stages(model, img01, stream: Path, seed: int):
    """The three pipeline calls process() makes, timed one by one."""
    h, w = img01.shape[1:3]
    gen = torch.Generator(device=img01.device).manual_seed(seed)
    _, t_c = host_ms(lambda: model.apply_condition_compress(img01, stream, h, w))
    (c_latent, guide_hint), t_d = host_ms(
        lambda: model.apply_condition_decompress(stream))
    out, t_s = host_ms(lambda: model.decode_pipeline(
        c_latent, guide_hint, STEPS, generator=gen))
    ms = {"encode_and_compress": t_c, "decompress": t_d,
          "relay_sample_and_vae_decode": t_s}
    return c_latent, guide_hint, out, ms


def phase_main_path(model, device, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    img01 = torch.from_numpy(
        rng.uniform(size=(1, *IMAGE_HW, 3)).astype(np.float32)).to(device)
    with tempfile.TemporaryDirectory() as tmp:
        stream = Path(tmp) / "image.rdeic"
        (warm_img, _), warm_ms = host_ms(
            lambda: run_process(model, img01, stream, seed))
        streams = [stream.read_bytes()]
        reset_counters()
        (img, bpp), ms = host_ms(lambda: run_process(model, img01, stream, seed))
        launches, shapes = read_counters()
        streams.append(stream.read_bytes())
        c_latent, guide_hint, out, stage_ms = run_stages(
            model, img01, stream, seed)
        streams.append(stream.read_bytes())
    log(f"[main] warm-up process() {warm_ms:.1f} ms")
    log(f"[main] image {IMAGE_HW[1]}x{IMAGE_HW[0]}: {len(streams[0])} bytes, "
        f"bpp={bpp:.5f}; process() {ms:.1f} ms; "
        f"stage ms: {json.dumps(stage_ms)}")
    log(f"[main] launches: {json.dumps(launches)}")
    if any(b != streams[0] for b in streams):
        raise AssertionError("the same image coded to different streams")
    if not np.array_equal(img, warm_img):
        raise AssertionError("process() gave two different images")
    # the encoder's own synthesis of the decoded slices, from the same feature
    with torch.no_grad():
        _, feature = model.encode_first_stage(img01 * 2 - 1)
        enc_latent, enc_hint = model.codec().compress(feature)["latents"]
    if not (torch.equal(c_latent, enc_latent)
            and torch.equal(guide_hint, enc_hint)):
        raise AssertionError("decoded latents differ from the encoder's")
    if tuple(out.shape) != (1, *IMAGE_HW, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)}")
    if not np.array_equal(img, to_uint8(out[0].cpu().numpy())):
        raise AssertionError("process() and the staged calls disagree")
    n_gn = sum(isinstance(m, GroupNorm32) for m in model.denoiser.modules())
    # 14 self-attentions over >= 1024 tokens per denoiser call at 768x512
    # (UNet 5 + 5, control 2 + 2), plus the two VAE mid-blocks; one launch
    # per GroupNorm32 call; no training kernel (no grad on this path)
    want = dict.fromkeys(KERNEL_FNS, 0)
    want.update({"flash_attn_fwd": 14 * STEPS + 2,
                 "group_norm_silu_fwd": n_gn * STEPS})
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return {"bpp": bpp, "ms": ms, "stage_ms": stage_ms, "launches": launches,
            "shapes": shapes}


def make_refine_model(model, seed: int) -> RDEIC:
    """The refine-phase model over `model`'s own tensors (shared, not
    copied: its training updates them), with LPIPS(alex) made on the card
    from `seed`, LeCun-normal as in make_model."""
    torch.manual_seed(seed)
    lpips = LPIPS("alex").to(next(model.parameters()).device)
    with torch.no_grad():
        for name, p in lpips.named_parameters():
            if name.endswith("weight"):
                p.normal_(0.0, p[0].numel() ** -0.5)
    refine = RDEIC(**REFINE_MODEL_CONFIG, device="meta").eval()
    refine.load_state_dict(
        {**model.state_dict(),
         **{f"lpips.{k}": v for k, v in lpips.state_dict().items()}},
        assign=True)
    return refine


def cpu_copy(model) -> RDEIC:
    """The same model with its weights copied to the CPU."""
    config = REFINE_MODEL_CONFIG if model.is_refine else MODEL_CONFIG
    cpu = RDEIC(**config, device="meta").eval()  # weights follow
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        assign=True)
    return cpu


def phase_reference(model, device, seed: int):
    """256x256 through the card (kernels) and the CPU (plain versions)."""
    rng = np.random.default_rng(seed + 1)
    img = rng.uniform(size=(1, 256, 256, 3)).astype(np.float32) * 2 - 1
    with tempfile.TemporaryDirectory() as tmp:
        stream = Path(tmp) / "small.rdeic"
        model.apply_condition_compress(
            torch.from_numpy(img * 0.5 + 0.5).to(device), stream, 256, 256)
        c_latent, guide_hint = model.apply_condition_decompress(stream)
    relay = torch.from_numpy(rng.normal(size=c_latent.shape).astype(np.float32))
    steps = [torch.from_numpy(rng.normal(size=c_latent.shape).astype(np.float32))
             for _ in range(STEPS)]
    cpu = cpu_copy(model)
    results = {}
    with torch.no_grad():
        for name, m, dev in (("cuda", model, device),
                             ("cpu", cpu, torch.device("cpu"))):
            out = m.decode_pipeline(c_latent.to(dev), guide_hint.to(dev), STEPS,
                                    relay_noise=relay.to(dev),
                                    step_noise=[s.to(dev) for s in steps])
            _, feat = m.encode_first_stage(torch.from_numpy(img).to(dev))
            results[name] = (out.cpu(), feat.cpu())
    err_img = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    err_feat = ((results["cuda"][1] - results["cpu"][1]).abs().max()
                / results["cpu"][1].abs().max()).item()
    log(f"[reference] 256x256, card vs CPU: image max|diff| {err_img:.3g} "
        f"(limit 2e-3), VAE feature max|diff|/max {err_feat:.3g} (limit 1e-4)")
    if not (err_img <= 2e-3 and err_feat <= 1e-4):
        raise AssertionError("the card disagrees with the CPU reference")


def _grad_reads(got: dict, want: dict, floor: float) -> dict:
    """Per tensor: max |got - want| / max(max |want|, floor)."""
    return {k: (got[k] - w).abs().max().item() / max(w.abs().max().item(), floor)
            for k, w in want.items()}


def train_ref_group(name: str) -> str:
    """The training reference's group of a trainable tensor."""
    if name.startswith("denoiser."):
        return "denoiser"
    return "synthesis" if name.startswith(SYNTHESIS_PREFIXES) else "rate"


def _hook_convs(model, fn) -> list:
    """fn(name, output) as a forward hook on every Conv of the compression
    model and, in the refine phase, every convolution of LPIPS (its return
    value, if any, replaces the output); the handles."""
    mods = [(f"compression.{n}", m) for n, m in model.compression.named_modules()
            if isinstance(m, Conv)]
    if model.is_refine:
        mods += [(f"lpips.{n}", m) for n, m in model.lpips.named_modules()
                 if isinstance(m, torch.nn.Conv2d)]
    return [mod.register_forward_hook(
                lambda _mod, _args, out, name=name: fn(name, out))
            for name, mod in mods]


def phase_train_reference(model, device, seed: int) -> dict:
    """One B = 1, 256x256 training loss of the model's phase and its
    trainable gradients, on the card (kernels) and on the CPU (plain
    versions), from the same weights and noise; the CPU run takes the card's
    convolution outputs in the compression model (see TRAIN_REF_TOL), a
    second CPU run does not. At 256x256, L = 1024 reaches the flash kernels
    at d = 16 and 64 (and, in the refine phase's VAE decoder, d = 512)."""
    tag = "refine-reference" if model.is_refine else "train-reference"
    rng = np.random.default_rng(seed + 3)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32))
    noise = model.train_noise(img, torch.Generator().manual_seed(seed))
    cpu = cpu_copy(model)
    card_convs, conv_reads = {}, {}

    def record(name, out):  # LPIPS runs its backbone twice (image, target)
        card_convs.setdefault(name, []).append(out.detach().cpu())

    def pin(name, out):
        calls = sum(k.split("#")[0] == name for k in conv_reads)
        if calls == len(card_convs[name]):
            raise AssertionError(f"{name} ran more often than on the card")
        want = card_convs[name][calls]
        conv_reads[f"{name}#{calls}"] = ((out.detach() - want).abs().max()
                                         / want.abs().max()).item()
        return out + (want - out).detach()

    results = {}
    for name, m, hook in (("cuda", model, record), ("cpu", cpu, pin),
                          ("cpu_unpinned", cpu, None)):
        dev = next(m.parameters()).device
        params = trainable_parameters(m)
        moved = {k: [u.to(dev) for u in v] if isinstance(v, list) else v.to(dev)
                 for k, v in noise.items()}
        handles = _hook_convs(m, hook) if hook else []
        t0 = time.perf_counter()
        with full_fp32():
            loss, _ = m.loss_fn(img.to(dev), noise=moved)
            grads = torch.autograd.grad(loss, list(params.values()))
        for h in handles:
            h.remove()
        results[name] = (loss.item(), {k: g.cpu() for k, g in zip(params, grads)})
        log(f"[{tag}] {name}: loss {loss.item():.6f} and "
            f"{len(grads)} gradients in {time.perf_counter() - t0:.1f} s")
    del cpu
    (l_card, g_card), (l_cpu, g_cpu), (l_free, g_free) = (
        results[k] for k in ("cuda", "cpu", "cpu_unpinned"))
    floor = TRAIN_REF_FLOOR * max(g.abs().max().item() for g in g_cpu.values())
    reads = _grad_reads(g_card, g_cpu, floor)
    free = _grad_reads(g_card, g_free, floor)
    faults = _grad_reads({k: g * FAULT_SCALE for k, g in g_card.items()},
                         g_cpu, floor)
    worst_conv = max(conv_reads, key=conv_reads.get)
    out = {"loss": abs(l_card - l_cpu) / abs(l_cpu),
           "fault_loss": abs(l_card * FAULT_SCALE - l_cpu) / abs(l_cpu),
           "loss_unpinned": abs(l_card - l_free) / abs(l_free),
           "conv": conv_reads[worst_conv]}
    ok = (out["loss"] <= TRAIN_REF_TOL["loss"] < out["fault_loss"]
          and out["conv"] <= TRAIN_REF_TOL["conv"])
    log(f"[{tag}] {len(conv_reads)} conv outputs (compression model"
        f"{', LPIPS' if model.is_refine else ''}), CPU from the card's inputs "
        f"vs the card: worst max|diff|/max "
        f"{out['conv']:.3g} ({worst_conv}; limit {TRAIN_REF_TOL['conv']})")
    for group in ("denoiser", "synthesis", "rate"):
        keys = [k for k in reads if train_ref_group(k) == group]
        worst = sorted(keys, key=reads.get, reverse=True)[:3]
        out[group] = reads[worst[0]]
        out[f"unpinned_{group}"] = max(free[k] for k in keys)
        out[f"fault_{group}"] = max(faults[k] for k in keys)
        ok = ok and out[group] <= TRAIN_REF_TOL[group] < out[f"fault_{group}"]
        log(f"[{tag}] {group} ({len(keys)} tensors): card vs CPU worst "
            f"{out[group]:.3g} (limit {TRAIN_REF_TOL[group]}): "
            + ", ".join(f"{k} {reads[k]:.3g}" for k in worst)
            + f"; a planted x{FAULT_SCALE} fault reads "
            f"{out[f'fault_{group}']:.3g}; against the unpinned CPU run "
            f"{out[f'unpinned_{group}']:.3g}")
    log(f"[{tag}] loss: card vs CPU {out['loss']:.3g} (limit "
        f"{TRAIN_REF_TOL['loss']}), planted fault {out['fault_loss']:.3g}, "
        f"unpinned {out['loss_unpinned']:.3g}")
    if not ok:
        raise AssertionError(f"[{tag}] training on the card disagrees with "
                             "the CPU, or a planted fault reads within its "
                             "limit")
    return out


def train_launches_per_step(model) -> dict:
    """Kernel launches of one training micro-step at 512x512, from the
    model's structure: the denoiser runs once (independent phase) or once
    per sampler step (refine); each of its flash self-attentions runs the
    forward with lse (twice when the blocks are recomputed in the backward
    or the sampler step is), dq and dkv once; each GroupNorm32 call is one
    forward launch (again when its block or step is recomputed) and two
    backward launches. The VAE encoder's mid-block attention runs the plain
    forward without grad; in the refine phase the decoder's runs the
    forward with lse (twice with the decoder's use_checkpoint), dq and
    dkv."""
    den = model.denoiser
    n_gn = sum(isinstance(m, GroupNorm32) for m in den.modules())
    blocks = [*den.base.input_blocks, den.base.mid, *den.base.output_blocks,
              *den.control.input_blocks, den.control.mid]
    n_gn_recomputed = sum(isinstance(m, GroupNorm32)
                          for b in blocks for m in b.modules())
    ckpt = 1 if den.use_checkpoint else 0
    n_flash = FLASH_PER_DENOISER_CALL_512
    calls, step_remat, decoder = 1, 0, 0
    if model.is_refine:
        calls, decoder = model.fixed_step, 1
        step_remat = 1 if model.scan_remat else 0
    dec_ckpt = 1 if model.vae.decoder.use_checkpoint else 0
    return {"flash_attn_fwd": 1,
            "flash_attn_fwd_lse": (calls * n_flash * (1 + ckpt + step_remat)
                                   + decoder * (1 + dec_ckpt)),
            "flash_attn_bwd_dq": calls * n_flash + decoder,
            "flash_attn_bwd_dkv": calls * n_flash + decoder,
            "group_norm_silu_fwd": calls * (
                n_gn + ckpt * n_gn_recomputed + step_remat * n_gn),
            "group_norm_silu_bwd": 2 * calls * n_gn}


def phase_training(model, device, seed: int) -> dict:
    """The full-width training path of the model's phase: one warm-up
    micro-step, then TRAIN_STEPS (independent) or REFINE_STEPS (refine)
    counted and timed ones."""
    tag, cfg, steps = (("refine", REFINE_CONFIG, REFINE_STEPS) if model.is_refine
                       else ("train", TRAIN_CONFIG, TRAIN_STEPS))
    rng = np.random.default_rng(seed + 2)
    hw = cfg["out_size"]
    imgs = [torch.from_numpy(rng.uniform(
        -1, 1, (cfg["batch_size"], hw, hw, 3)).astype(np.float32)).to(device)
        for _ in range(1 + steps)]
    trainer = Trainer(model, learning_rate=cfg["learning_rate"],
                      accumulate_grad_batches=cfg["accumulate_grad_batches"])
    # snapshots on the host, so that the peak below is the training's own
    frozen = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()
              if k not in trainer.params and k != "vq_embed_prob"}
    start = {k: p.detach().to("cpu", copy=True) for k, p in trainer.params.items()}
    prob = model.vq_embed_prob.clone()
    gen = torch.Generator(device=device).manual_seed(seed)
    logs, warm_ms = host_ms(lambda: trainer.step(imgs[0], generator=gen))
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], [logs["loss"].item()]
    for img in imgs[1:]:
        logs, ms = host_ms(lambda: trainer.step(img, generator=gen))
        step_ms.append(ms)
        if not (torch.isfinite(logs["loss"]) and torch.isfinite(logs["grad_norm"])):
            raise AssertionError(f"non-finite loss or gradient: {logs}")
        losses.append(logs["loss"].item())
    peak = torch.cuda.max_memory_allocated()
    launches, shapes = read_counters()
    per_step = train_launches_per_step(model)
    want = {k: v * steps for k, v in per_step.items()}
    ms = float(np.mean(step_ms))
    log(f"[{tag}] warm-up micro-step {warm_ms:.1f} ms; micro-steps (B = "
        f"{cfg['batch_size']}, {hw}x{hw}) {json.dumps(step_ms)} ms, "
        f"mean {ms:.1f} ms, {cfg['batch_size'] * 1e3 / ms:.3f} images/s; "
        f"peak memory {peak / 2**30:.2f} GiB; losses {json.dumps(losses)}")
    log(f"[{tag}] launches per micro-step: "
        f"{json.dumps({k: v / steps for k, v in launches.items()})}")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    if trainer.step_count != 1 + steps:
        raise AssertionError("the trainer skipped a step")
    now = model.state_dict()
    for k, v in frozen.items():
        if not torch.equal(v, now[k].cpu()):
            raise AssertionError(f"frozen tensor {k} changed")
    moved = 0
    for k, p in trainer.params.items():
        state = trainer.optimizer.state.get(p, {})
        if "exp_avg" not in state:
            raise AssertionError(f"{k} took no optimizer step")
        if torch.count_nonzero(state["exp_avg"]) and torch.equal(p.cpu(), start[k]):
            raise AssertionError(f"{k} has a gradient but did not move")
        moved += 1
    if torch.equal(prob, model.vq_embed_prob):
        raise AssertionError("the codebook usage did not move")
    log(f"[{tag}] {moved} trainable tensors stepped, {len(frozen)} frozen "
        "tensors bit-equal, codebook usage moved")
    return {"ms": ms, "step_ms": step_ms, "warm_ms": warm_ms,
            "images_per_s": cfg["batch_size"] * 1e3 / ms, "steps": steps,
            "peak_bytes": peak, "launches": launches, "shapes": shapes,
            "losses": losses}


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _bound_ms(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    """The least ms for `nbytes` of HBM traffic and `flops` at `rate`
    flop/s, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_rate(d: int, dtype) -> tuple[float, str]:
    """(flop/s, its name) that bounds a flash kernel at head dim d. fp32:
    the TF32 tensor cores over the three passes of 3xTF32 where the kernel
    runs them (TC_HEAD_DIMS), else fp32 FMA. bf16: the card's bf16 peak,
    whichever route the kernel takes (its TF32 products could be bf16 ones)."""
    if dtype == torch.float32 and d in TC_HEAD_DIMS:
        return TF32_FLOPS / 3, f"TF32 tensor cores {TF32_FLOPS / 1e12:g} / 3 passes"
    return PEAK_FLOPS[dtype], ("fp32 FMA 67" if dtype == torch.float32
                               else "bf16 989")


def _flash_bound_ms(nbytes: float, flops: float, d: int,
                    dtype) -> tuple[float, str, str]:
    """bound ms, what bounds it, and the rate used (flash_rate)."""
    rate, name = flash_rate(d, dtype)
    return (*_bound_ms(nbytes, flops, rate), f"{name} = {rate / 1e12:.1f} TFLOP/s")


def compare(name, got, want, tol) -> dict:
    """max |got - want| against `tol`, and the reading of a planted fault
    (got scaled by FAULT_SCALE), which must exceed `tol`."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    fault = (got * FAULT_SCALE - want).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max|diff| {err} > {tol}")
    if not fault > tol:
        raise AssertionError(f"{name}: a x{FAULT_SCALE} fault reads {fault}, "
                             f"within the limit {tol}")
    return {"max_abs_err": err, "tol": tol, "fault_err": fault}


def flash_tol(dtype, want: torch.Tensor) -> float:
    """fp32: kernel and plain both sum in fp32, in other orders. bf16: their
    fp32 results, ~1e-6 apart, each round to bf16 (8 significant bits), so
    they differ by at most one bf16 ulp of max|plain|; the limit is two."""
    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7 + 1)


def check_flash(device, shape, dtype, reps):
    q, k, v = (_randn(shape, dtype, device, s) for s in range(3))
    want = flash_attention_plain(q, k, v)
    r = compare(f"flash {shape} {dtype}", flash_attention(q, k, v), want,
                flash_tol(dtype, want))
    b, seq, h, d = shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound, by, rate = _flash_bound_ms(4 * q.numel() * q.element_size(),
                                      4.0 * b * h * seq * seq * d, d, dtype)
    return {**r, "bound_ms": bound, "bound_by": by, "bound_rate": rate,
            **timings(lambda: flash_attention(q, k, v),
                      lambda: F.scaled_dot_product_attention(qt, kt, vt), reps),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 2)}


def timings(fn, library, reps) -> dict:
    """ms (back to back), device_ms and host_us a call of the kernel's
    wrapper `fn` and of the library call (device_ms)."""
    dev, host = device_ms(fn, reps)
    lib_dev, lib_host = device_ms(library, reps)
    return {"ms": cuda_ms(fn, reps), "device_ms": dev, "host_us": host * 1e3,
            "library_ms": cuda_ms(library, reps), "library_device_ms": lib_dev,
            "library_host_us": lib_host * 1e3}


def check_groupnorm(device, key, reps):
    """fp32: the kernel against the plain version, GN_TOL absolute. bf16:
    against the plain version on the same values in fp32, unrounded, at
    REL_TOL of max (as the training rows)."""
    b, c, h, w, groups, eps, silu, dtype = key
    dtype = getattr(torch, dtype)
    x = _randn((b, c, h, w), dtype, device, 0) * 3 + 1
    wt, bs = (_randn((c,), torch.float32, device, s) for s in (1, 2))
    reads = []
    for e in (1e-5, 1e-6):  # both eps and both SiLU settings
        for s in (False, True):
            name = f"group_norm {key} eps={e} silu={s}"
            got = group_norm(x, wt, bs, groups, e, s)
            if dtype == torch.float32:
                reads.append(compare(name, got,
                                     group_norm_plain(x, wt, bs, groups, e, s),
                                     GN_TOL))
            else:
                want = group_norm_plain(x.float(), wt, bs, groups, e, s)
                reads.append(compare_rel(name, [(got, want, REL_TOL[dtype])]))
    bound, by = _bound_ms(2 * x.numel() * x.element_size() + 2 * c * 4,
                          10.0 * x.numel(), PEAK_FLOPS[dtype])

    def library():
        y = F.group_norm(x, groups, wt.to(dtype), bs.to(dtype), eps)
        return F.silu(y) if silu else y

    return {"max_abs_err": max(r["max_abs_err"] for r in reads),
            "tol": reads[0]["tol"],
            "fault_err": min(r["fault_err"] for r in reads),
            "bound_ms": bound, "bound_by": by,
            **timings(lambda: group_norm(x, wt, bs, groups, eps, silu), library,
                      reps),
            "plain_ms": cuda_ms(
                lambda: group_norm_plain(x, wt, bs, groups, eps, silu), reps)}


def compare_rel(name, pairs) -> dict:
    """Each (got, want, tol): max |got - want| / max |want| against tol, and
    the reading of a planted fault (got scaled by FAULT_SCALE), which must
    exceed tol."""
    rel, fault, abs_err = [], [], []
    for i, (got, want, tol) in enumerate(pairs):
        got, want = got.float(), want.float()
        scale = want.abs().max().item()
        abs_err.append((got - want).abs().max().item())
        rel.append(abs_err[-1] / scale)
        fault.append((got * FAULT_SCALE - want).abs().max().item() / scale)
        if not rel[-1] <= tol:
            raise AssertionError(f"{name} output {i}: max|diff|/max {rel[-1]} > {tol}")
        if not fault[-1] > tol:
            raise AssertionError(f"{name} output {i}: a x{FAULT_SCALE} fault "
                                 f"reads {fault[-1]}, within the limit {tol}")
    return {"max_abs_err": max(abs_err), "max_rel_err": max(rel),
            "tol": [t for _, _, t in pairs], "fault_err": min(fault)}


def check_flash_train(device, shape, dtype, reps) -> dict:
    """The lse forward, dq and dkv kernels against the plain versions on one
    shape: {kernel name: row}."""
    q, k, v, do = (_randn(shape, dtype, device, s) for s in range(4))
    tol = REL_TOL[dtype]
    o, lse = flash_attention_lse(q, k, v)
    # the plain versions on the same values in fp32: their results unrounded
    want_o, want_lse = flash_attention_lse_plain(q.float(), k.float(), v.float())
    r_lse = compare_rel(f"flash lse {shape} {dtype}",
                        [(o, want_o, tol), (lse, want_lse, REL_TOL[torch.float32])])
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    pdq, pdk, pdv = flash_attention_bwd_plain(
        *(x.float() for x in (q, k, v, o)), lse, do.float())
    r_dq = compare_rel(f"flash dq {shape} {dtype}", [(dq, pdq, tol)])
    r_dkv = compare_rel(f"flash dkv {shape} {dtype}",
                        [(dk, pdk, tol), (dv, pdv, tol)])
    b, seq, h, d = shape
    n, size, rows = q.numel(), q.element_size(), b * h * seq * 4
    ops = float(b * h * seq * seq * d)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                  retain_graph=True), reps)
    plain_bwd = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), 2)
    # the whole backward does S, dP, dV, dQ and dK once each (10 B H L^2 d
    # flops; reads q, k, v, o, dO and lse, writes dq, dk and dv); the dq and
    # dkv kernels each recompute S and dP, so their own bounds add up to 14
    pair_bound, _, _ = _flash_bound_ms(8 * n * size + rows, 10 * ops, d,
                                       dtype)
    lib_bwd_dev, _ = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), reps)
    rows_out = {}

    def fwd_library():
        return F.scaled_dot_product_attention(qt, kt, vt)

    for name, r, fn, nbytes, flops, plain, library, library_dev in (
            ("flash_attn_fwd_lse", r_lse,
             lambda: flash_attention_lse(q, k, v),
             4 * n * size + rows, 4 * ops,
             cuda_ms(lambda: flash_attention_lse_plain(q, k, v), 2),
             cuda_ms(fwd_library, reps), device_ms(fwd_library, reps)[0]),
            ("flash_attn_bwd_dq", r_dq,
             lambda: flash_attention_dq(q, k, v, o, lse, do),
             6 * n * size + 2 * rows, 6 * ops, plain_bwd, lib_bwd, lib_bwd_dev),
            ("flash_attn_bwd_dkv", r_dkv,
             lambda: flash_attention_dkv(q, k, v, do, lse, di),
             6 * n * size + 2 * rows, 8 * ops, plain_bwd, lib_bwd,
             lib_bwd_dev)):
        bound, by, rate = _flash_bound_ms(nbytes, flops, d, dtype)
        rows_out[name] = {**r, "bound_ms": bound, "bound_by": by,
                          "bound_rate": rate,
                          "ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, reps)[0],
                          "plain_ms": plain, "library_ms": library,
                          "library_device_ms": library_dev}
        if name != "flash_attn_fwd_lse":
            rows_out[name]["backward_bound_ms"] = pair_bound
    return rows_out


def check_groupnorm_bwd(device, key, dtype, reps) -> dict:
    """The backward kernels against the plain backward on one shape, with
    SiLU off and on, from the forward kernel's mean and 1/std."""
    b, c, h, w, groups, _, silu, _ = key
    x = _randn((b, c, h, w), dtype, device, 0) * 3 + 1
    dy = _randn((b, c, h, w), dtype, device, 3)
    wt, bs = (_randn((c,), torch.float32, device, s) for s in (1, 2))
    tol = REL_TOL[dtype]
    reads = []
    for s in (False, True):
        _, mean, inv = group_norm_fwd(x, wt, bs, groups, 1e-5, s)
        got = group_norm_bwd(x, wt, bs, mean, inv, dy, groups, s)
        want = group_norm_bwd_plain(x.float(), wt, bs, mean, inv, dy.float(),
                                    groups, s)  # unrounded, as for flash
        reads.append(compare_rel(
            f"group_norm_bwd {key} silu={s} {dtype}",
            [(got[0], want[0], tol), (got[1], want[1], REL_TOL[torch.float32]),
             (got[2], want[2], REL_TOL[torch.float32])]))
    _, mean, inv = group_norm_fwd(x, wt, bs, groups, 1e-5, silu)
    # F.group_norm takes weight and bias in the input's dtype
    xl, wl, bl = (t.detach().to(dtype).requires_grad_() for t in (x, wt, bs))
    y = F.group_norm(xl, groups, wl, bl, 1e-5)
    y = F.silu(y) if silu else y
    bound, by = _bound_ms(3 * x.numel() * x.element_size() + 4 * c * 4,
                          15.0 * x.numel(), PEAK_FLOPS[dtype])
    return {"max_abs_err": max(r["max_abs_err"] for r in reads),
            "max_rel_err": max(r["max_rel_err"] for r in reads),
            "tol": reads[0]["tol"], "fault_err": min(r["fault_err"] for r in reads),
            "bound_ms": bound, "bound_by": by,
            **timings(lambda: group_norm_bwd(x, wt, bs, mean, inv, dy, groups,
                                             silu),
                      lambda: torch.autograd.grad(y, (xl, wl, bl), dy,
                                                  retain_graph=True), reps),
            "plain_ms": cuda_ms(lambda: group_norm_bwd_plain(
                x, wt, bs, mean, inv, dy, groups, silu), reps)}


def summarize(name, route, source, replaces, path, runs, rows):
    """One kernel's line: per-shape rows weighted by their calls in one run
    of `path` (per image, or per training micro-step); `ms_by_path` weights
    the kernel's time by each path's calls."""
    def total(key, p=path):
        return sum(r[key] * r["calls"].get(p, 0) for r in rows)
    bound = total("bound_ms")
    by_ops = sum(r["bound_ms"] * r["calls"].get(path, 0) for r in rows
                 if r["bound_by"] == "operations")
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "path": path,
            "launches": runs[path]["launches"][name],
            "launches_by_path": {p: run["launches"][name]
                                 for p, run in runs.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "device_ms": total("device_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": bound,
            "bound_by": "operations" if by_ops >= bound / 2 else "bytes",
            "library_ms": total("library_ms"),
            "library_device_ms": total("library_device_ms"),
            "ms_by_path": {p: total("ms", p) for p in runs
                           if any(p in r["calls"] for r in rows)},
            **({"backward_bound_ms": total("backward_bound_ms")}
               if "backward_bound_ms" in rows[0] else {}),
            **({"bound_rates": sorted({r["bound_rate"] for r in rows})}
               if "bound_rate" in rows[0] else {}),
            "shapes": rows}


def sdpa_backend(shape, device) -> str:
    """The backend torch's default dispatch gives F.scaled_dot_product_
    attention for fp32 [B, L, H, D] = `shape` (the library time's)."""
    from torch.nn.attention import SDPBackend  # noqa: PLC0415

    q = _randn(shape, torch.float32, device, 0).transpose(1, 2)
    try:
        return SDPBackend(torch._fused_sdp_choice(q, q, q)).name
    except (AttributeError, RuntimeError, ValueError) as exc:
        return f"unknown ({exc})"


def phase_kernels(device, runs) -> list:
    """Every kernel against its plain version at every shape that a path
    of `runs` ({"serve": ..., "train": ..., "refine": ...}) gave it."""
    def calls(name, key) -> dict:
        """Calls per run of each path of kernel `name` at shape `key`."""
        return {p: run["shapes"][name][key] / run.get("steps", 1)
                for p, run in runs.items() if key in run["shapes"][name]}

    def keys(name, paths=tuple(runs)) -> list:
        return sorted(set().union(*(runs[p]["shapes"][name] for p in paths)))

    serve_keys = [(*shape, "float32") for shape in FLASH_SHAPES]
    flash_rows = []
    for key in serve_keys + [k for k in keys("flash_attn_fwd")
                             if k not in serve_keys]:
        for dtype in (torch.float32, torch.bfloat16):
            r = check_flash(device, key[:4], dtype, reps=5)
            log(f"[kernels] flash {key[:4]} {dtype}: {json.dumps(r)}")
            if dtype == getattr(torch, key[4]):
                flash_rows.append({"shape": list(key),
                                   "calls": calls("flash_attn_fwd", key), **r})
    gn_rows = []
    for key in keys("group_norm_silu_fwd"):
        reps = 20 if key in runs["serve"]["shapes"]["group_norm_silu_fwd"] else 5
        r = check_groupnorm(device, key, reps=reps)
        log(f"[kernels] group_norm {key}: {json.dumps(r)}")
        gn_rows.append({"shape": list(key),
                        "calls": calls("group_norm_silu_fwd", key), **r})
    for key in GN_STREAM_KEYS:
        r = check_groupnorm(device, key, reps=3)
        log(f"[kernels] group_norm {key} (on no path, streamed): {json.dumps(r)}")
        if key[7] == "float32":
            gn_rows.append({"shape": list(key), "calls": {}, **r})

    train_paths = ("train", "refine")
    train_rows = {k: [] for k in ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv", "group_norm_silu_bwd")}
    for p in train_paths:
        if (set(runs[p]["shapes"]["flash_attn_bwd_dq"])
                != set(runs[p]["shapes"]["flash_attn_fwd_lse"])):
            raise AssertionError(f"{p}: the backward ran at other shapes than "
                                 "the forward")
    for key in keys("flash_attn_fwd_lse", train_paths):
        for dtype in (torch.float32, torch.bfloat16):
            rows = check_flash_train(device, key[:4], dtype, reps=3)
            log(f"[kernels] flash training {key[:4]} {dtype}: {json.dumps(rows)}")
            if dtype == getattr(torch, key[4]):
                for name, r in rows.items():
                    train_rows[name].append(
                        {"shape": list(key), "calls": calls(name, key), **r})
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            key = (*shape, str(dtype).removeprefix("torch."))
            r = check_flash(device, shape, dtype, reps=3)
            log(f"[kernels] flash {shape} (on no path) {dtype}: {json.dumps(r)}")
            rows = check_flash_train(device, shape, dtype, reps=3)
            log(f"[kernels] flash training {shape} (on no path) {dtype}: "
                f"{json.dumps(rows)}")
            if dtype == torch.float32:
                flash_rows.append({"shape": list(key), "calls": {}, **r})
                for name, row in rows.items():
                    train_rows[name].append({"shape": list(key), "calls": {},
                                             **row})
    for key in keys("group_norm_silu_bwd", train_paths):
        for dtype in (torch.float32, torch.bfloat16):
            r = check_groupnorm_bwd(device, key, dtype, reps=10)
            log(f"[kernels] group_norm_bwd {key} {dtype}: {json.dumps(r)}")
            if dtype == getattr(torch, key[7]):
                train_rows["group_norm_silu_bwd"].append(
                    {"shape": list(key),
                     "calls": calls("group_norm_silu_bwd", key), **r})

    flash_src = "rdeic_torch/csrc/flash_attn_fwd.cu"
    bwd_src = "rdeic_torch/csrc/flash_attn_bwd.cu"
    gn_src = "rdeic_torch/csrc/group_norm_fwd.cu"
    gn_bwd_src = "rdeic_torch/ops/fused_groupnorm.py"
    lines = [
        summarize("flash_attn_fwd", "cuda", flash_src,
                  "rdeic_tpu/ops/flash_attention.py:32", "serve", runs,
                  flash_rows),
        summarize("flash_attn_fwd_lse", "cuda", flash_src,
                  "rdeic_tpu/ops/flash_attention.py:122", "refine", runs,
                  train_rows["flash_attn_fwd_lse"]),
        summarize("flash_attn_bwd_dq", "cuda", bwd_src,
                  "rdeic_tpu/ops/flash_attention.py:261", "refine", runs,
                  train_rows["flash_attn_bwd_dq"]),
        summarize("flash_attn_bwd_dkv", "cuda", bwd_src,
                  "rdeic_tpu/ops/flash_attention.py:300", "refine", runs,
                  train_rows["flash_attn_bwd_dkv"]),
        summarize("group_norm_silu_fwd", "cuda", gn_src,
                  "rdeic_tpu/ops/fused_groupnorm.py:116", "serve", runs,
                  gn_rows),
        summarize("group_norm_silu_bwd", "triton", gn_bwd_src,
                  "rdeic_tpu/ops/fused_groupnorm.py:144", "refine", runs,
                  train_rows["group_norm_silu_bwd"]),
    ]
    for path in train_paths:
        for d in (None, 16, 64, 512):
            dq, dkv = ({key: sum(r[key] * r["calls"].get(path, 0)
                                 for r in train_rows[name]
                                 if d is None or r["shape"][3] == d)
                        for key in ("ms", "bound_ms", "backward_bound_ms",
                                    "library_ms")}
                       for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"))
            what = "all head dims" if d is None else f"d = {d}"
            log(f"[kernels] flash backward per {path} micro-step, {what}: "
                f"dq + dkv {dq['ms'] + dkv['ms']:.3f} ms; bound of the whole "
                f"backward {dq['backward_bound_ms']:.3f} ms; dq's and dkv's "
                f"own bounds {dq['bound_ms']:.3f} + {dkv['bound_ms']:.3f} ms; "
                f"SDPA backward {dq['library_ms']:.3f} ms")
    gn = lines[4]
    n_calls = sum(r["calls"].get("serve", 0) for r in gn_rows)
    host_us = sum(r["host_us"] * r["calls"].get("serve", 0) for r in gn_rows)
    lib_us = sum(r["library_host_us"] * r["calls"].get("serve", 0)
                 for r in gn_rows)
    log(f"[kernels] GroupNorm forward per image ({n_calls:g} calls, "
        f"{gn['launches']} launches): kernel ms {gn['ms']:.3f}, device_ms "
        f"{gn['device_ms']:.3f}, host {host_us / n_calls:.1f} us a call; "
        f"F.group_norm + F.silu ms {gn['library_ms']:.3f}, device_ms "
        f"{gn['library_device_ms']:.3f}, host {lib_us / n_calls:.1f} us a call")
    for d in (16, 64, 512):
        per = {key: sum(r[key] * r["calls"].get("serve", 0) for r in flash_rows
                        if r["shape"][3] == d)
               for key in ("ms", "device_ms", "library_ms", "library_device_ms",
                           "bound_ms")}
        log(f"[kernels] flash forward per image at d = {d}: "
            + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))
    log(f"[kernels] SDPA's backend at the VAE's d = 512 in fp32: "
        f"{sdpa_backend((2, 4096, 1, 512), device)}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description="rdeic_torch smoke run on one GPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    phase_environment()
    phase_build()
    t0 = time.perf_counter()
    model = make_model(device, args.seed)
    torch.cuda.synchronize()
    log(f"[main] full-width model on the card in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.0f} M params)")
    runs = {"serve": phase_main_path(model, device, args.seed)}
    phase_reference(model, device, args.seed)
    phase_train_reference(model, device, args.seed)
    runs["train"] = phase_training(model, device, args.seed)
    refine = make_refine_model(model, args.seed)
    phase_train_reference(refine, device, args.seed)
    runs["refine"] = phase_training(refine, device, args.seed)
    kernels = phase_kernels(device, runs)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
