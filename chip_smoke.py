"""Drive rdeic_torch on one NVIDIA GPU and check every kernel it runs.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (for the flash-attention kernel), triton and g++;
no network. Phases, each fatal on failure:

1. environment: torch / CUDA / triton versions and the card's name and power
   limit (nvidia-smi);
2. build: nvcc and g++ start together on the sources in the checkout;
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
5. kernels against their plain versions at every main-path shape, with the
   kernel, plain and library times (CUDA events) and the bound of each. Each
   comparison also reads a planted fault (the kernel's output scaled by
   1.05) and fails if that reading is within the limit.

The last two lines of stdout are the kernel summary
`{"kernels": [...]}` and `{"ok": true, "device": {...}}`. `ms`, `plain_ms`,
`bound_ms` and `library_ms` of a kernel are summed over its calls in one
main-path run (per image); `shapes` has the per-call numbers. `launches`
counts kernel launches: one per flash call, two per GroupNorm call (stats,
then apply).
"""
from __future__ import annotations

import argparse
import json
import math
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
from rdeic_torch.models.blocks import GroupNorm32
from rdeic_torch.ops.flash_attention import flash_attention, flash_attention_plain
from rdeic_torch.ops.fused_groupnorm import group_norm, group_norm_plain
from rdeic_torch.pipeline.rdeic import RDEIC
from rdeic_torch.utils.backend import resolve_device
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

IMAGE_HW = (512, 768)  # a Kodak-sized image, landscape
STEPS = 2
# H100 SXM data-sheet peaks (NVIDIA; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
FAULT_SCALE = 1.05  # a planted output-scale error each check must see
GN_TOL = 1e-4  # fp32 GroupNorm outputs up to ~15 after scale and bias
FLASH_SHAPES = [(1, 6144, 5, 64), (1, 6144, 4, 16), (1, 6144, 1, 512),
                (1, 1536, 10, 64), (1, 1536, 8, 16)]


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
    for line in build.build_log(libs["flash_attn_fwd"]).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


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


def reset_counters():
    for fn in (flash_attention, group_norm):
        fn.launches = 0
        fn.shapes = {}


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
        launches = {"flash_attn_fwd": flash_attention.launches,
                    "group_norm_silu_fwd": group_norm.launches}
        shapes = {"flash_attn_fwd": dict(flash_attention.shapes),
                  "group_norm_silu_fwd": dict(group_norm.shapes)}
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
    # (UNet 5 + 5, control 2 + 2), plus the two VAE mid-blocks; two launches
    # per GroupNorm32 call
    want = {"flash_attn_fwd": 14 * STEPS + 2,
            "group_norm_silu_fwd": 2 * n_gn * STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return {"bpp": bpp, "ms": ms, "stage_ms": stage_ms, "launches": launches,
            "shapes": shapes}


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
    cpu = RDEIC(**MODEL_CONFIG, device="meta").eval()  # weights follow
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        assign=True)
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


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    bound, by = _bound_ms(4 * q.numel() * q.element_size(),
                          4.0 * b * h * seq * seq * d, dtype)
    return {**r, "bound_ms": bound,
            "bound_by": by, "ms": cuda_ms(lambda: flash_attention(q, k, v), reps),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 2),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)}


def check_groupnorm(device, key, reps):
    b, c, h, w, groups, eps, silu, dtype = key
    dtype = getattr(torch, dtype)
    x = _randn((b, c, h, w), dtype, device, 0) * 3 + 1
    wt, bs = (_randn((c,), torch.float32, device, s) for s in (1, 2))
    reads = [compare(f"group_norm {key} eps={e} silu={s}",
                     group_norm(x, wt, bs, groups, e, s),
                     group_norm_plain(x, wt, bs, groups, e, s), GN_TOL)
             for e in (1e-5, 1e-6)  # both eps and both SiLU settings
             for s in (False, True)]
    bound, by = _bound_ms(2 * x.numel() * x.element_size() + 2 * c * 4,
                          10.0 * x.numel(), dtype)

    def library():
        y = F.group_norm(x, groups, wt, bs, eps)
        return F.silu(y) if silu else y

    return {"max_abs_err": max(r["max_abs_err"] for r in reads), "tol": GN_TOL,
            "fault_err": min(r["fault_err"] for r in reads),
            "bound_ms": bound, "bound_by": by,
            "ms": cuda_ms(lambda: group_norm(x, wt, bs, groups, eps, silu), reps),
            "plain_ms": cuda_ms(
                lambda: group_norm_plain(x, wt, bs, groups, eps, silu), reps),
            "library_ms": cuda_ms(library, reps)}


def summarize(name, route, source, replaces, launches, rows):
    """One kernel's line: per-shape rows weighted by main-path calls."""
    def total(key):
        return sum(r[key] * r["calls"] for r in rows)
    by_ops = sum(r["bound_ms"] * r["calls"] for r in rows
                 if r["bound_by"] == "operations")
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if by_ops >= total("bound_ms") / 2 else "bytes",
            "library_ms": total("library_ms"), "shapes": rows}


def phase_kernels(device, main) -> list:
    flash_rows = []
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            r = check_flash(device, shape, dtype, reps=5)
            key = (*shape, str(dtype).removeprefix("torch."))
            log(f"[kernels] flash {key}: {json.dumps(r)}")
            if dtype == torch.float32:
                count = main["shapes"]["flash_attn_fwd"].get(key, 0)
                flash_rows.append({"shape": list(key), "calls": count, **r})
    checked = {tuple(r["shape"]) for r in flash_rows}
    missing = set(main["shapes"]["flash_attn_fwd"]) - checked
    if missing:
        raise AssertionError(f"main-path flash shapes not checked: {missing}")
    gn_rows = []
    for key, count in sorted(main["shapes"]["group_norm_silu_fwd"].items()):
        r = check_groupnorm(device, key, reps=20)
        log(f"[kernels] group_norm {key}: {json.dumps(r)}")
        gn_rows.append({"shape": list(key), "calls": count, **r})
    return [
        summarize("flash_attn_fwd", "cuda", "rdeic_torch/csrc/flash_attn_fwd.cu",
                  "rdeic_tpu/ops/flash_attention.py:32",
                  main["launches"]["flash_attn_fwd"], flash_rows),
        summarize("group_norm_silu_fwd", "triton",
                  "rdeic_torch/ops/fused_groupnorm.py",
                  "rdeic_tpu/ops/fused_groupnorm.py:116",
                  main["launches"]["group_norm_silu_fwd"], gn_rows),
    ]


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
    main_result = phase_main_path(model, device, args.seed)
    phase_reference(model, device, args.seed)
    kernels = phase_kernels(device, main_result)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
