"""Drive rdeic_torch on one NVIDIA GPU and check every kernel it runs.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (for the flash-attention and GroupNorm kernels)
and g++; no network. Phases, each fatal on failure:

1. environment: torch / CUDA versions and the card's name and power limit
   (nvidia-smi);
2. build: nvcc (forward and backward flash kernels, GroupNorm forward and
   backward, the interleaved-lane rANS kernels of csrc/device_rans.cu) and
   g++ start together on the sources in the checkout; ptxas's registers
   and spills of each CUDA kernel are logged by name, and a flash kernel
   (all run on the tensor cores; any entry whose mangled name holds
   `flash_`) or the GroupNorm backward that spills fails the run, and any
   ptxas C75xx advisory (wgmma serialized: C7519 a `warpgroup.arrive` it
   injected, C7512 too few registers, C7513 registers of a wgmma written
   while it runs) is logged, and fails the run in a Hopper kernel; the
   Hopper kernels (HOPPER_KERNELS: the forward at every head dim,
   flash_fwd_d16_bf16, flash_fwd_d16, flash_fwd_d64_bf16, flash_fwd_d64,
   flash_fwd_d512_bf16 and flash_fwd_d512, the d = 64 backward,
   flash_dq_d64_bf16 and flash_dkv_d64_bf16 in bf16, flash_dq_d64 and
   flash_dkv_d64 in fp32, and the fp32 d = 512 backward) must hold
   warpgroup products and TMA loads (flash_fwd_d16: cp.async.bulk,
   UBLKCP):
   `cuobjdump -sass` of each built library counts each one's HGMMA and
   UTMALDG instructions, and a count of 0 fails the run; `[wgmma]` logs
   how the card's wgmma rounds (`rdeic_torch.tools.wgmma_probe`);
3. main path at the full width of configs/model/rdeic.yaml (random weights
   from --seed): the CLI's per-image `rdeic_torch.inference.process` codes a
   synthetic 768x512 image to a stream file, decodes it back, relay-samples
   it in 2 DDPM steps and decodes it with the VAE. It runs once to warm up
   (cuDNN plans), then once, timed, with every kernel's
   launch count set to 0. A third, uncounted run makes the same three
   pipeline calls one by one, timed per stage. Checks: the stream is the
   same every time; process() gives the same image both times, equal to the
   staged run's; the staged image is 512x768x3 and finite; the decoded
   (c_latent, guide_hint) equal the encoder's synthesis bit for bit; each
   kernel ran as often as the model's structure says; the counted run's
   peak memory (`max_memory_allocated`, and above what was resident);
3b. the serving path with the CLI's other flags, each run and checked as in
   3, from the same weights: (a) `--sampler ddim`; (b) classifier-free
   guidance at 2.0 (DDPM), whose steps also run the base UNet alone (10
   more flash launches a step, one more per base GroupNorm32); (c) `--bf16`
   (DDPM) on a bf16 copy (the state dict loaded onto a `meta` model, then
   `set_compute_dtype`), whose flash and GroupNorm calls must all be bf16,
   whose stream the fp32 model must decode to the same latents bit for bit,
   and which must leave the fp32 model fp32;
3c. batched serving through `rdeic_torch.inference_partition`'s chunk
   functions (`make_chunks`, `serve`): four 768x512 images and one
   512x512 (two padded sizes, two chunks), `--batch_size` 4 and
   `--micro_batch_size` 2, the codec stage of chunk k + 1 in its worker
   thread beside the sampling of chunk k, as the CLI runs it; one warm-up
   run, then one counted run, then each chunk again stage by stage
   (serially, timed: codec and sampling ms an image). (a) fp32, (b) the
   bf16 copy of 3b (every flash call bf16; its streams, coded by the fp32
   compression model, decode on the fp32 model to the same latents),
   (c) with captions: a full-width CLIP text tower (random weights from
   the seed) attached to the fp32 model, on tokens from a small merges
   file the script writes, conditions the sampler; the tower against a
   CPU copy of it on the same tokens within CLIP_REF_TOL, beside a planted
   x1.05 fault. Checks of each run: every stream the same in both runs,
   equal to the serial codec stage's and to `apply_condition_compress` of
   that image alone; `decompress_batch` rows bit-equal to each stream
   decoded alone; each image bit-equal to `decode_pipeline` of its
   micro-batch with the same noise and context; outputs finite and [B, H,
   W, 3]; launches as the chunks' structure says (`partition_launches`);
   ms an image, peak memory;
3d. tiled serving through rdeic_torch.pipeline.tiled (the tiled CLI's
   functions) on a synthetic TILED_HW (1356 x 2040: DIV2K's width; the
   padding to 1408 x 2048 and the crop run) image in 512 tiles
   overlapping by 64 (15 tiles): (a) `tiled_v2`, cross-tile context (the
   default), fp32, tile batch 4 (a ragged last batch of 3); (b)
   `tiled_v2_bf16`, the same on 3b's bf16 copy; (c) `tiled_v1`,
   independent tiles, fp32, all 15 tiles in one sampling call, under
   RDEIC_RANS_LANES=128 (each tile a lanes container the card decodes).
   Each a warm-up, a counted run, then each stage again, timed (compress,
   decompress, tile sampling, blend). Checks: the same stream every time;
   the stream's codec groups equal the codec's on the encoder's features
   (v2: the stitched map; v1: each tile's); the decoded latent tiles equal
   the encoder's synthesis bit for bit; the image equals the blend of
   `decode_pipeline` of each tile batch with the same noise, bit for bit,
   and that blend the plain NumPy blend within 1e-6; [1, 1356, 2040, 3],
   finite, in [0, 1]; launches as the grid's structure says
   (`tiled_launches`); under (c), the first tile's passes decoded again,
   each against the plain version and the host coder; ms an image and per
   megapixel, peak memory, bpp;
3e. the interleaved-lane codec on phase 3's 768x512 image through the
   model's entry points, each route (LANE_ROUTES) under its RDEIC_RANS_*
   settings with RDEIC_RANS_OVERHEAD_PCT=0 (so K holds) and the codec built
   anew under them: v1 at K = 128, v2 at K = 128 (the card decodes), v2 at
   K = 16 (below RDEIC_RANS_DEVICE_MIN_LANES: the host's
   SharedRansDecoder, counted in the codec's `host_routes`), the device
   encoder (RDEIC_RANS_DEVICE_ENC=1) and a batch of LANE_BATCH images
   (`apply_condition_{compress,decompress}_batch`); a warm-up, then a
   counted compress and decompress. Checks: the launch counts of each
   route (the lane decoder a pass, the encoder once, none on the host
   route, whose count must read 1); the device encoder's payload equals
   the v1 route's (`rans_encode_interleaved`), without overflow; the
   decoded latents equal the encoder's synthesis bit for bit; every pass of
   the kernel (its inputs recorded) equals the plain version on the CPU and
   the host coder reading the same stream; a stream with a flipped byte
   decodes, pass by pass, to the plain version's symbols, without a fault;
   the encoder's launch equals the plain version's words; decompress ms
   and bpp per route beside phase 3's host route;
3f. [harness], the evaluation harnesses' per-image functions on numpy
   images (the card's machine has no PIL): baseline_inference's
   `process_single` on two synthetic 768x512 images (stream and image
   bit-equal to process() with the same generator; ms an image, peak
   memory), image_checker's rows on its outputs, run_ood's `eval_image`
   at two test-time draws with NIQE and BRISQUE fit on synthetic originals
   (`nr_models`; every score finite, NIQE reading a noised image as less
   natural), run_robustness's `sweep_image` on phase 3's stream on the host
   route and on the lane route (v2, K = 128: rans_decode_shared on
   corrupted words; each severity-0 row phase 3's image bit for bit, the
   fail rates, no launch faulting the context, phase 3's stream decoding
   to its latents afterwards), and `device_trace` around one
   decode_pipeline (the trace file's size, the ten device ops that took
   longest) with `memory_stats` against the allocator; launches of each
   part as the structure says (paths harness_baseline, harness_ood,
   harness_robustness, harness_robustness_lanes);
4. reference on a small input: a 256x256 image through the same weights,
   once on the card (kernels) and once on the CPU (plain versions), from the
   same latents and noise: DDPM, DDIM and guidance 2.0 in fp32 (image
   within 2e-3), and the bf16 model against a CPU copy of it (relative
   RMS: the image within BF16_REF_TOL, the VAE feature within
   BF16_FEATURE_TOL); a planted x1.05 fault must read outside each limit;
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
9. bf16 training reference: the model as the repo's bf16 recipes build
   it (BF16_RECIPE: computing in bf16, its frozen tensors made in bf16 by
   `fast_init` on `meta` from the seed, the trainable ones fp32), one
   independent-phase micro-step as 5, the CPU copy computing in bf16 too
   and taking the card's VAE encoder outputs besides 5's; the loss and each
   group of gradients within BF16_TRAIN_REF_TOL, which a planted x1.05
   fault reads outside of; then one `Trainer(frozen_dtype=bf16)` step on
   the card: the frozen tensors stay bf16 and bit-equal, the trainable ones
   fp32, the codebook usage fp32;
10. bf16 independent-phase training at the full width, as 6 on that model
   (every flash call of the path bf16; the frozen tensors bf16 and
   bit-equal after the update);
11. bf16 refine-phase reference, as 9 on the refine model of
   configs/train_rdeic_refine_v5e.yaml (`remat_policy: "dots"`, sharing
   9's tensors, LPIPS(alex) made by `fast_init` and stored in bf16);
12. bf16 refine-phase training at the full width, as 8 on that model;
13. kernels against their plain versions at every shape of the serving and
   the training paths, fp32 and bf16 (bf16 rows for the bf16 runs' calls;
   GroupNorm forward and backward each read with fp32 and with bf16 scale
   and bias, the kernels' two parameter branches, and keep a row for each
   (x, scale and bias) dtype pair a path ran, timed in it), and at shapes
   on no path (their rows carry no
   calls): flash at d = 512 and d = 64 with B = 2, H > 1 and L = 1000, and
   at d = 64 and d = 16 with L = 8192, at d = 64 with L = 130, and at
   d = 16 with B = 2, H = 3 and L = 1000 (the CHECK_SHAPES; the forward
   with lse is also held to the output limit of the forward without it,
   `flash_tol`), GroupNorm forward
   and backward at a span larger than a cluster's shared memory
   (GN_STREAM_KEYS: the kernels' streaming variant), in fp32 and bf16, with
   the kernel, plain and library times (CUDA events) and the bound of each;
   the GroupNorm backward also gives the same bits on a second run.
   `ms` times launches back to back, so a launch-bound call reads its host
   time; `device_ms` (and `library_device_ms`) times the same launches
   queued behind a sleeping kernel, so it reads the card's time alone
   (device_ms); GroupNorm rows add the host µs a call takes to enqueue.
   A flash row's bound takes the rate named in its `bound_rate`
   (flash_rate): for fp32, the TF32 tensor cores over the three passes of
   3xTF32, which every flash kernel runs; for bf16, the card's bf16 peak.
   Each forward, dq and dkv row names its CUDA kernel (`kernel`: the bf16
   forward runs flash_fwd_d16_bf16 / flash_fwd_d64_bf16 /
   flash_fwd_d512_bf16, the bf16 backward at d = 16 flash_dq_d16_bf16 and
   flash_dkv_d16_bf16, at d = 64 flash_dq_d64_bf16 and flash_dkv_d64_bf16,
   at d = 512 flash_dq_d512_bf16 and flash_dkv_d512_bf16; the fp32
   forward flash_fwd_d16 (after flash_fwd_d16_split), flash_fwd_d64 and
   flash_fwd_d512, and the
   fp32 backward at d = 64 flash_dq_d64 and flash_dkv_d64 and at d = 512
   flash_dq_d512 and flash_dkv_d512, on TF32 wgmma),
   and a log line gives each bf16 row's times beside
   SDPA's bf16 call, another each d = 16 forward row's (both dtypes, with
   and without lse: ms, device_ms, host µs, bound, exponentials' floor and
   SDPA's); another gives each training shape's dq and dkv times
   (ms and device_ms), their own bounds, the pair's and the pair's
   exponentials' floor beside SDPA's backward. Each
   flash row also has `softmax_bound_ms`, the floor its B H L^2
   exponentials set on the MUFU units (16 a clock per SM at 1.98 GHz),
   which `bound_ms` (products and bytes only) leaves out.
   Each comparison also reads a planted fault (the kernel's output scaled
   by 1.05) and fails if that reading is within the limit; the backward
   kernels also give the same bits on a second launch. A log line gives the
   fp32 backward's error against float64 at d = 16, 64 and 512, L = 1024
   and 8192: how each design's error moves with L; at d = 64 and 512
   (per-tile partials on wgmma) L = 8192 must read below BWD64_F64_TOL and
   BWD512_F64_TOL of max and within twice L = 1024; another the fp32
   forward's at d = 512 and d = 16, L = 1024 and 8192 (flash_fwd_d512 and
   flash_fwd_d16: per-tile partials), which must read below FWD512_F64_TOL
   and FWD16_F64_TOL and at L = 8192 within twice L = 1024;
14. validation (tagged `[validate]`, the root train.py's `run_validation`
   and `ImageLogger` as the training CLI calls them, on in-memory batches
   of configs/dataset/lic_valid.yaml's 1 x 512x512): (a) after phase 8
   (before phase 13), the fp32 independent model, one warm-up then
   VAL_BATCHES counted batches of 5 sampler steps with psnr, ms_ssim and
   lpips (LPIPS on random weights): ms a batch, peak memory, launches a
   batch against the
   model's self-attention shapes (hooks on every self-attention: each of
   >= 1024 tokens runs flash, the UNet's 32x32 level included; 3 a batch
   at d = 512, one VAE encoder and two decoder mid-blocks) and its
   GroupNorm32 calls, every average finite; (c) the image logger at B = 2
   into a temporary directory, its three PNGs read back through zlib equal
   to the panels byte for byte; (d) after phase 4 (before any training,
   on the weights made from --seed), one 256x256 image through
   run_validation on the card and on a CPU copy, the same noise, 2 steps:
   avg_bpp, avg_psnr, avg_lpips and usage within VAL_REF_TOL, each beside
   a planted x1.05 fault; logged beside them, the codebook's smallest
   top-2 logit gap and y - mu's smallest distance from a rounding edge,
   the card-vs-CPU differences of those inputs, and how many codebook
   indices and rounded symbols differ; (b) after phase 12, the bf16 refine model
   (`fixed_step` 2) as (a), every flash call bf16 and no GroupNorm call
   with both x and its scale and bias fp32;
15. [ddp_nccl], after 14b: a world of one NCCL rank (a FileStore) around the
   data-parallel `Trainer` (its all-reduce of the gradients and the logs,
   its gather of the hyper latent) on phase 10's bf16 model, B = 2,
   512x512, one warm-up and DDP_STEPS micro-steps at accumulation
   DDP_ACCUMULATE, against the plain `Trainer` from the same weights,
   batches and noise, both under cuDNN's deterministic algorithms: logs,
   weights, AdamW's moments, the codebook and its usage bit-equal; ms a
   micro-step; the all-reduces' bytes and ms (CUDA events);
16. [ddp_gloo_2], after 15: two ranks of this script on the one card (NCCL
   takes no two ranks on one device), gloo over a local port, fp32
   independent at the full width from the seed's weights, B = 2 split
   1 + 1, DDP_STEPS micro-steps at DDP_ACCUMULATE: the ranks start and end
   bit-equal (weight digests rank 0 broadcasts); rank 0 first runs the
   plain `Trainer` on the whole batch (and again on the images nudged by
   +-1e-6) and holds its ranks' steps to it: logs within 1e-5, the mean
   gradients within 1e-4 of max or twice their nudge move (behind
   LeakyReLU's kinks), the weights within 2 lr and to 1e-6 where the
   gradient is firm, the code usage over each set of copied codes to 1e-6;
   a failed rank fails the phase;
17. [partition_dp], after 3c: phase 3c's fp32 images through `serve` over
   two replicas on this card (what `--dp 2` runs: the noise drawn at each
   micro-batch's size, its rows split, a thread a replica): streams
   byte-equal to [partition]'s, images within 1e-5, launches, ms an image;
18. [tiled_mesh], after 3d: `--use_mesh` over the one card, [tiled_v2]'s
   stream decoded again with the mesh's replicas: bit-equal to
   [tiled_v2]'s image (one device pads nothing), launches, decode ms;
19. [tp_gloo_2], after 16: two ranks of this script on the one card, gloo,
   the full-width fp32 independent model from the seed after
   `shard_params` on a dp = 1, tp = 2 mesh (each rank holds its half of
   every sharded kernel; the layers all-gather their outputs and all-reduce
   dX): a warm-up and TP_STEPS micro-steps at DDP_ACCUMULATE, B = 2,
   256x256 (the top level's L = 1024: flash forward, dq and dkv and both
   GroupNorm kernels run under TP); rank 0 against the plain Trainer on a
   whole copy, the same weights, batch and noise: logs within 1e-5,
   gathered gradients within 1e-4 of max or twice their +-1e-6 nudge
   move, weights within 2 lr; the replicated weights bit-equal across the
   ranks; the gathered step_N.pt resumes in a tp = 1 Trainer, which steps;
   printed: each rank's weight bytes against tp = 1's, the collectives'
   calls, bytes and ms a micro-step (CUDA events and host), ms a
   micro-step, launches;
20. [tp_decode], in 19's ranks before their training: phase 3's stream
   decoded under the sharded weights: latents bit-equal, the image within
   1e-5 of phase 3's, launches as phase 3's decode, decode ms;
21. [export], after 19: `save_params_npz` of the full-width fp32 model
   from the seed to a file, `load_npz_weights` into a fresh model: state
   dicts bit-equal; again after the bf16 recipe's casts of the same model
   (its frozen tensors in bf16: the file's fp32 upcast is exact).

The last two lines of stdout are the kernel summary
`{"kernels": [...]}` and `{"ok": true, "device": {...}}`. Three of the
kernels are the lane codec's (rans_decode_lanes, rans_decode_shared,
rans_encode_lanes, route cuda, `csrc/device_rans.cu`), each with its
path's image's calls (phase 3e: lanes_v1, lanes_v2, lanes_device_enc)
replayed and timed, `plain_ms` of the plain version on the CPU (its only
device), `bound_ms` from the bytes the calls move, `serial_chain_ms` (the
calls' steps times the dependent loads or divisions of a step, each at the
latency `rans_chain_probe` measures on the card: the chain no lane can
shorten), `max_abs_err` the largest |kernel - plain| of phase 3e's check of
those calls, and no library call (`library_ms` null). `ms`, `plain_ms`,
`bound_ms` and `library_ms` of a kernel are summed over its calls in one
run of the path its `path` names (serve: phase 3's DDPM run; serve_ddim,
serve_cfg and serve_bf16 are phase 3b's; partition and partition_bf16
phase 3c's, whose `calls` are per run of its five images; tiled_v2,
tiled_v2_bf16 and tiled_v1 phase 3d's, per run of its image; the lanes_*
routes phase 3e's; the harness_* paths phase 3f's, per run of each part;
partition_dp, tiled_mesh, ddp_nccl and ddp_gloo_2
phases 17, 18, 15 and 16 (the last per rank, read back from rank 0);
tp_gloo_2 and tp_decode phases 19 and 20 (per rank, from rank 0); train, refine,
train_bf16 and
refine_bf16 phases 6, 8, 10 and 12; validate and validate_bf16 phase
14a and 14b, whose `calls` are per validation batch): per image for the
serving kernels (flash_attn_fwd, group_norm_silu_fwd), per refine
micro-step for the
others (`ms_by_path` also gives the kernel time per independent-phase
micro-step); `shapes` has the per-call numbers and the calls in each path.
`launches` counts kernel launches in that path's counted run (one per flash
call and per GroupNorm call, forward or backward), `launches_by_path` in
each path's. The plain and library times of
flash_attn_bwd_dq and flash_attn_bwd_dkv are each of a whole backward (dq,
dk and dv): compare them with the sum of the two kernels, and so is their
`backward_bound_ms` (10 B H L^2 d flops: S, dP, dV, dQ, dK once each);
each kernel's own `bound_ms` counts the S and dP it recomputes.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gzip
import json
import math
import os
import re
import socket
import subprocess
import struct
import sys
import tempfile
import time
import zipfile
import zlib
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from rdeic_torch import baseline_inference, build, image_checker
from rdeic_torch.entropy import device_rans
from rdeic_torch.entropy.coder import (
    CdfTable,
    RansDecoder,
    SharedRansDecoder,
    rans_encode_interleaved,
    rans_encode_interleaved_shared,
)
from rdeic_torch.experiments import run_ood, run_robustness
from rdeic_torch.inference import process
from rdeic_torch.inference_partition import make_chunks, serve
from rdeic_torch.models import compression as compression_module
from rdeic_torch.models.clip import OpenCLIPTextEncoder, SimpleTokenizer
from rdeic_torch.models.blocks import Conv, GroupNorm32
from rdeic_torch.models.lpips import LPIPS
from rdeic_torch.models.unet import CrossAttention
from rdeic_torch.models.vae import AttnBlock
from rdeic_torch.ops import gaussian
from rdeic_torch.ops.attention import FLASH_MIN_TOKENS
from rdeic_torch.ops.flash_attention import (
    d512_clusters,
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
from rdeic_torch.parallel import tensor as tp_tensor
from rdeic_torch.parallel.mesh import (
    gather_state_dict,
    make_mesh,
    shard_params,
    tp_layers,
)
from rdeic_torch.parallel.tensor import gather_blocks
from rdeic_torch.pipeline import tiled
from rdeic_torch.pipeline.codec import parse_lane_header
from rdeic_torch.pipeline.rdeic import RDEIC
from rdeic_torch.train.trainer import (
    Trainer,
    cast_frozen,
    is_frozen_float,
    trainable_parameters,
    trainable_predicate,
)
from rdeic_torch.tools import wgmma_probe
from rdeic_torch.train.callbacks import ImageLogger, make_grid
from rdeic_torch.train.validation import run_validation
from rdeic_torch.utils.backend import full_fp32, resolve_device
from rdeic_torch.utils.checkpoint_io import load_npz_weights, save_params_npz
from rdeic_torch.utils.fast_init import fast_random_init
from rdeic_torch.utils.image import PNG_SIGNATURE, to_float01, to_uint8
from rdeic_torch.utils.metrics import MetricSuite, score_images
from rdeic_torch.utils.profiling import device_trace, memory_stats

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
# above); the model is MODEL_CONFIG with is_refine (phases 7 and 8 run it in
# fp32 with use_checkpoint as the model YAML sets it)
REFINE_CONFIG = {"learning_rate": 2.0e-5, "accumulate_grad_batches": 1,
                 "batch_size": 2, "out_size": 512}
REFINE_MODEL_CONFIG = {**MODEL_CONFIG, "is_refine": True}
# the bf16 recipes' trainer dtypes (every bf16 YAML of the repo sets these
# with fast_init) and train_rdeic_refine_v5e.yaml's model overrides:
# is_refine, and use_checkpoint with remat_policy "dots" on both UNets (held
# equal to the files as above); phases 9-12 run them
BF16_RECIPE = {"compute_dtype": "bfloat16", "frozen_dtype": "bfloat16",
               "fast_init": True}
BF16 = torch.bfloat16


def _with_dots(cfg: dict) -> dict:
    return {**cfg, "params": {**cfg["params"], "use_checkpoint": True,
                              "remat_policy": "dots"}}


REFINE_DOTS_MODEL_CONFIG = {
    **REFINE_MODEL_CONFIG,
    "control_stage_config": _with_dots(MODEL_CONFIG["control_stage_config"]),
    "unet_config": _with_dots(MODEL_CONFIG["unet_config"])}

IMAGE_HW = (512, 768)  # a Kodak-sized image, landscape
STEPS = 2
TRAIN_STEPS = 4  # timed micro-steps after one warm-up: one AdamW update
REFINE_STEPS = 3  # timed refine micro-steps after one warm-up, each updating
# the training paths: phases 6 and 8 (fp32), 10 and 12 (bf16), and 19
# (fp32 under tensor parallel, at 256x256: shapes of its own)
TRAIN_PATHS = ("train", "refine", "train_bf16", "refine_bf16", "tp_gloo_2")
# self-attentions over >= 1024 tokens per dual-UNet call at 512x512 (UNet
# L = 4096 h5 d64 x5 and L = 1024 h10 d64 x5, control L = 4096 h4 d16 x2 and
# L = 1024 h8 d16 x2; L = 256 goes to the plain product)
FLASH_PER_DENOISER_CALL_512 = 14
# the same at 768x512 (UNet L = 6144 h5 d64 x5 and L = 1536 h10 d64 x5,
# control L = 6144 h4 d16 x2 and L = 1536 h8 d16 x2), and of the base UNet
# alone (classifier-free guidance's unconditional branch)
FLASH_PER_DENOISER_CALL_768 = 14
FLASH_PER_BASE_CALL_768 = 10
CFG_SCALE = 2.0  # phase 3b's and phase 4's classifier-free guidance
# phase 3c, batched serving through rdeic_torch.inference_partition's chunk
# functions: four 768x512 images and one 512x512 (two padded sizes, so two
# chunks), the CLI's default --batch_size and a sampling micro-batch of 2
PARTITION_SIZES = [IMAGE_HW] * 4 + [(512, 512)]
PARTITION_BATCH = 4
PARTITION_MICRO = 2
PARTITION_CAPTIONS = ["a photo of the cat", "the cat and the dog",
                      "photo of a stop sign", "", "the cat"]
PARTITION_MERGES = ["t h", "th e</w>", "c a", "ca t</w>", "p h", "ph o",
                    "pho t", "phot o</w>", "o f</w>", "a n", "an d</w>"]
# phase 3c's CLIP tower, card vs CPU on the same tokens: max |card - cpu|
# over max |cpu| of the [B, 77, 1024] context; both sum in fp32 (no TF32)
# through 23 blocks, in other orders. A x1.05 fault reads 5e-2.
CLIP_REF_TOL = 1e-4
# phase 3d, tiled serving through rdeic_torch.pipeline.tiled (the tiled
# CLI's functions): a synthetic image of DIV2K's 2040-pixel width, 1356
# high (neither a multiple of 64, so the padding to 2048 x 1408 and the
# crop run), in the CLI's 512 tiles overlapping by 64: 3 x 5 = 15 tiles
TILED_HW = (1356, 2040)
TILE, OVERLAP = 512, 64
# channel slices of the compression model: two coded passes each
SLICES = MODEL_CONFIG["preprocess_config"]["params"]["slice_num"]
# phase 3e, the interleaved-lane codec on phase 3's image: each route's
# RDEIC_RANS_* settings (each run under RDEIC_RANS_OVERHEAD_PCT=0, so K
# holds); the batch route codes LANE_BATCH images of that size
LANE_ROUTES = {
    "lanes_v1": {"RDEIC_RANS_LANES": "128", "RDEIC_RANS_SHARED": "0"},
    "lanes_v2": {"RDEIC_RANS_LANES": "128"},
    "lanes_v2_k16": {"RDEIC_RANS_LANES": "16"},
    "lanes_device_enc": {"RDEIC_RANS_LANES": "128",
                         "RDEIC_RANS_DEVICE_ENC": "1"},
    "lanes_batch": {"RDEIC_RANS_LANES": "128"},
}
LANE_BATCH = 4
LANE_CHAIN_STEPS = 4096  # one lane's pass that times a step of each kernel
# the dependent links of one step of each lane kernel (see device_rans.cu):
# v1 the LUT gather and the CDF gathers on its symbol (the word's address is
# known as the step begins); v2 those and the word, whose place waits for
# the block's count of pulling lanes; the encoder the slot code's division
# (its lookups do not depend on the state). Escapes add links: left out, so
# the chain stays a least time.
CHAIN_LINKS = {"rans_decode_lanes": ("load", 2),
               "rans_decode_shared": ("load", 3),
               "rans_encode_lanes": ("divide", 1)}
CHASE_INTS = 1 << 21  # the pointer chase's int32, the LUT's 8 MiB
CHASE_LINKS = 1 << 16
# the lane kernels' rows: name -> (wrapper, the JAX function's line, the
# path whose counted run gives its launches)
RANS_ROWS = {
    "rans_decode_lanes": ("decode_pass", "rdeic_tpu/entropy/device_rans.py:114",
                          "lanes_v1"),
    "rans_decode_shared": ("decode_pass_shared",
                           "rdeic_tpu/entropy/device_rans.py:226", "lanes_v2"),
    "rans_encode_lanes": ("encode_lanes",
                          "rdeic_tpu/entropy/device_rans.py:365",
                          "lanes_device_enc"),
}
# phase 14, validation: configs/dataset/lic_valid.yaml's crop and batch
# (tests/test_torch_port_validation.py holds them equal to the file), the
# root train.py's metrics and sampler steps, and how many batches run
VAL_CONFIG = {"out_size": 512, "batch_size": 1}
VAL_METRICS = ("psnr", "ms_ssim", "lpips")
VAL_STEPS = 5  # run_validation's sample_steps (the refine phase: fixed_step)
VAL_BATCHES = 2  # counted batches, after one warm-up batch
VAL_LOG_BATCH = 2  # images the image logger draws in phase 14c
VAL_REF_HW = 256  # phase 14d's card-vs-CPU batch
VAL_REF_STEPS = 2
# phase 14d, card vs CPU: |card - cpu| / |cpu| of each average of a pass.
# The relay sample agrees within 2e-3 at the worst pixel (phase 4's
# limit), far less on average: PSNR read 2.3e-7 of itself and LPIPS
# (random weights, near 0) 1.1e-6 on an H100 at seed 0; bpp (1.3e-7) is a
# sum of log-likelihoods of rounded symbols, where a symbol at a rounding
# edge may flip (~1e-4). usage counts the same codebook indices: exact. A
# x1.05 fault reads 5e-2. The phase runs on the weights made from --seed,
# before any training: on the weights phases 6 and 8 train, which differ
# from run to run (the card's avg_bpp read 0.59136 to 0.59240 in four runs
# of seed 0 on an H100), one run read avg_bpp 1.42e-3 and the others ~1e-7.
# On the seed's weights two processes of seed 0 read the same card values
# bit for bit; y - mu's nearest rounding edge is 8.2e-6 away against a
# card-vs-CPU difference of 5.6e-6, and the closest codes tie exactly in
# fp32 on both (each takes the first): no choice differs.
VAL_REF_TOL = {"avg_bpp": 1e-3, "avg_psnr": 1e-4, "avg_lpips": 1e-3,
               "usage": 0.0}
# card vs CPU training reference: max |g_card - g_cpu| of each trainable
# tensor over max |g_cpu| of that tensor, or over TRAIN_REF_FLOOR x the
# largest gradient where the tensor's own gradient is zero but for rounding
# (a bias right before a GroupNorm, which removes the channel mean). The
# compression model's forward has kinks (LeakyReLU's slope at 0, the
# rounding of y - mu, lower_bound's gradient rule, the codebook's argmax and
# its contrastive loss's top-k selections) and weights the rate term by
# 1 / likelihood, so a forward rounding difference of ~1e-7 moves its
# gradients by up to ~1e-2 between two correct runs, and a near tie in the
# codebook's distances that falls the other way moves the codebook's own
# gradient by ~0.2. The CPU run therefore takes the card's value at every
# convolution output of the compression model and at the codebook's logits
# (the gradient passes straight through), after holding each such output to
# TRAIN_REF_TOL["conv"]; the gradients then differ only by the backward's
# arithmetic. In the refine phase LPIPS's ReLUs
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
# bf16 training, card vs CPU (phases 9 and 11): both runs round every bf16
# layer's output to 8 significant bits, in other places, so their gradients
# differ by bf16 noise through the whole backward. The gates are phase 4's
# bf16 ones: the loss within 2^-6 relative, each group's gradients within
# 2^-5 by relative RMS (the measure of phase 4's bf16 gates: a x1.05 fault
# reads 5e-2). The CPU run takes the card's VAE encoder outputs (the frozen
# bf16 encoder runs without grad; its feature reads ~1.7e-2 card vs CPU at
# full width, phase 4) after holding them to 2^-5 by relative RMS, so the
# compression model sees the same input, and its convolution outputs are
# pinned and held as in phase 5; LPIPS's inputs are the bf16 decoder's
# output, so its convolution outputs are held by relative RMS to 2^-5
BF16_TRAIN_REF_TOL = {"loss": 2.0 ** -6, "grads": 2.0 ** -5,
                      "input": 2.0 ** -5}
SYNTHESIS_PREFIXES = ("compression.decoder.", "compression.out.")
TRAIN_REF_FLOOR = 1e-5
# H100 SXM data-sheet peaks (NVIDIA; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_FLOPS = 494.7e12
# Head dims whose flash kernels run on the tensor cores in TF32, an fp32
# product as three TF32 products (3xTF32), forward and backward
TC_HEAD_DIMS = {"forward": (16, 64, 512), "backward": (16, 64, 512)}
# Head dims whose bf16 forward has kernels of its own on the bf16 tensor
# cores (flash_fwd_d16_bf16, flash_fwd_d64_bf16, flash_fwd_d512_bf16: bf16
# wgmma), and whose bf16 backward has
# (flash_dq_d16_bf16, flash_dkv_d16_bf16, flash_dq_d64_bf16,
# flash_dkv_d64_bf16, flash_dq_d512_bf16, flash_dkv_d512_bf16: likewise):
# every head dim of the paths
BF16_FWD_HEAD_DIMS = (16, 64, 512)
BF16_BWD_HEAD_DIMS = (16, 64, 512)
# Head dims whose forward kernels, fp32 and bf16, run on wgmma with TMA
# loads (flash_fwd_d16, flash_fwd_d16_bf16, flash_fwd_d64,
# flash_fwd_d64_bf16, flash_fwd_d512, flash_fwd_d512_bf16): every one
HOPPER_FWD_HEAD_DIMS = (16, 64, 512)
# Head dims whose fp32 backward kernels run on TF32 wgmma with TMA loads
# (flash_dq_d64, flash_dkv_d64; flash_dq_d512, flash_dkv_d512)
HOPPER_BWD_FP32_HEAD_DIMS = (64, 512)
# Each library's kernels on wgmma with TMA loads (the forward at every head
# dim, the d = 64 backward in both dtypes and the fp32 d = 512 backward):
# phase 2 counts their HGMMA and TMA loads (UTMALDG; flash_fwd_d16 copies
# its operand images by cp.async.bulk, UBLKCP), and a ptxas C75xx advisory
# (wgmma serialized) in one of them fails the run
HOPPER_KERNELS = {"flash_attn_fwd": ("flash_fwd_d16", "flash_fwd_d16_bf16",
                                     "flash_fwd_d64", "flash_fwd_d64_bf16",
                                     "flash_fwd_d512", "flash_fwd_d512_bf16"),
                  "flash_attn_bwd": ("flash_dq_d64_bf16",
                                     "flash_dkv_d64_bf16", "flash_dq_d64",
                                     "flash_dkv_d64", "flash_dq_d512",
                                     "flash_dkv_d512")}
# The fp32 d = 64 backward's error against float64 at L = 8192, of max
# (phase 13): its per-tile partials keep it at its L = 1024 reading
# (~3e-6; the one-accumulator mma.sync design it replaced read 7.2e-5)
BWD64_F64_TOL = 5e-5
# The fp32 d = 512 backward's error against float64 at L = 8192, of max
# (phase 13): per-tile partials keep it flat in L. The CPU emulation of
# flash_dq_d512 / flash_dkv_d512 (tests/test_torch_port_flash_bwd_d512_fp32
# .py) reads 2.35e-6 at L = 8192 on 32 rows a side (one accumulator over L:
# 7.2e-5); the limit is about eight times it
BWD512_F64_TOL = 2e-5
# The fp32 d = 512 forward's error against float64 (max |o - o64|, phase
# 13): per-tile P V partials keep it flat in L. The CPU emulation of
# flash_fwd_d512 (tests/test_torch_port_flash_fwd_d512.py) reads 8.0e-7 at
# L = 1024 and 1.7e-7 at 4096 on 64 rows of normal draws (one accumulator a
# consumer: 1.1e-6 and 1.8e-6); the limit is five times the first
FWD512_F64_TOL = 4e-6
# The fp32 d = 16 forward's error against float64 (max |o - o64|, phase
# 13): per-tile P V partials keep it flat in L. The CPU emulation of
# flash_fwd_d16 (tests/test_torch_port_flash_d16.py) reads 4.7e-7 and
# 6.9e-7 at [1, 1024, 4, 16] (two draws), 2.4e-7 at L = 512 and 7.2e-8 at
# 4096 on 64 rows (one accumulator a consumer: 3.5e-7 and 1.0e-6); the
# limit is about six times the first
FWD16_F64_TOL = 4e-6
# The exponentials' floor of a flash call (`softmax_bound_ms`): B H L^2 of
# them on the MUFU units, 16 a clock per SM (sm_90), at the boost clock
MUFU_EX2_PER_CLOCK = 16
BOOST_CLOCK_HZ = 1.98e9
FAULT_SCALE = 1.05  # a planted output-scale error each check must see
# bf16 serving, card vs CPU: the RMS of the difference over the RMS of the
# CPU's result (the measure PSNR reads). Each bf16 run rounds every layer's
# output to 8 significant bits; the card's and the CPU's products sum in
# other orders and so round other ways, and the two runs land about as far
# from each other as from the fp32 result: 2.35e-2 of max at the worst
# element at full width (an H100 against its host's CPU, 256x256, seed 0),
# too near the ~5e-2 a x1.05 fault reads for a gate on the max, while the
# RMS of the noise is far below the fault's: 7.1e-3 on the image. The VAE
# encoder's 512-ch feature, after ~30 bf16 layers, reads 1.72e-2 there;
# it is held to twice the image's limit
BF16_REF_TOL = 2.0 ** -6
BF16_FEATURE_TOL = 2.0 ** -5
GN_TOL = 1e-4  # fp32 GroupNorm outputs up to ~15 after scale and bias
# relative to max |plain| of each output, for the training kernels: fp32
# sums in other orders land ~1e-6 apart. A bf16 output is held to the plain
# version's unrounded fp32 result (plain on the same values upcast): rounding
# to nearest bf16 moves a value by at most half an ulp, 2^-8 of its
# magnitude, so the limit is 2^-8 plus the fp32 limit
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -8 + 1e-4}
FLASH_SHAPES = [(1, 6144, 5, 64), (1, 6144, 4, 16), (1, 6144, 1, 512),
                (1, 1536, 10, 64), (1, 1536, 8, 16)]
# d = 512 shapes the full-width paths do not run: the 256x256 refine
# reference's (phase 7), an L two rows past a 32-row tile, a ragged L with
# B = 2 and H = 2 past a whole number of 64-row kept tiles, and twice the
# paths' longest L (the fp32 backward's clusters along d at each)
D512_CHECK_SHAPES = [(1, 1024, 1, 512), (1, 130, 1, 512), (2, 4097, 2, 512),
                     (1, 8192, 1, 512)]
# flash shapes on no path: B = 2, H > 1 (every path's d = 512 shape has
# H = 1) and an L that is a multiple of no tile of the tensor-core kernels,
# at every head dim; and at d = 64 and d = 16 twice the paths' longest L,
# as the backward's dq, dk and dv sums and the forward's output sum run
# over L; and at d = 64 an L two rows past a 128-row q tile (the Hopper
# forward's TMA boxes read zeros past L)
CHECK_SHAPES = [(2, 1000, 2, 512), (2, 1000, 3, 64), (1, 8192, 2, 64),
                (1, 130, 2, 64), (2, 1000, 3, 16), (1, 8192, 4, 16),
                *D512_CHECK_SHAPES]
# a GroupNorm span on no path larger than 8 CTAs' shared memory in both
# dtypes (16 x 65536 elements), so the forward and backward kernels
# stream it
GN_STREAM_KEYS = [(1, 512, 256, 256, 32, 1e-5, True, dt, dt)
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
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] nvcc + g++ in parallel: {time.perf_counter() - t0:.1f} s")
    spills, serialized = [], []
    for lib in ("flash_attn_fwd", "flash_attn_bwd", "group_norm_fwd",
                "group_norm_bwd", "device_rans"):
        kernel = mangled = "?"
        for line in build.build_log(libs[lib]).splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:  # a mangled name; a name the pattern misses stays whole
                mangled = kernel = entry[1]
                m = re.search(r"\d(flash_(?:fwd|dq|dkv)_d(?:16|64|512)(?:_bf16)?"
                              r"|gn_[fb]wd)(?:I(f|13__nv_bfloat16)"
                              r"((?:L[ib]\d+E)*))?(?![_a-z])", mangled)
                if m and m[2]:  # a template: its type and ints
                    ints = re.findall(r"L[ib](\d+)E", m[3])
                    what, n = {"fwd": ("vec", 1), "bwd": ("vec", 1)}.get(
                        m[1].rsplit("_", 1)[-1], ("", 0))
                    kernel = (f"{m[1]}<{'fp32' if m[2] == 'f' else 'bf16'}"
                              + (f", {what} = {', '.join(ints[:n])}"
                                 if ints else "") + ">")
                elif m:
                    kernel = m[1]
                rans = re.search(r"\d(rans_(?:decode_lanes|decode_shared"
                                 r"|encode_lanes))E", mangled)
                if rans:
                    kernel = rans[1]
            elif re.search(r"\(C75\d\d\)", line):  # wgmma serialized
                log(f"[build] {lib} ptxas {kernel}: {line.strip()}")
                if kernel in HOPPER_KERNELS.get(lib, ()):
                    serialized.append(kernel)
            elif "registers" in line or "spill" in line:
                log(f"[build] {lib} ptxas {kernel}: {line.strip()}")
                # every flash kernel and the GroupNorm backward, found in
                # the mangled name, so a renamed one is guarded too
                if (re.search(r"flash_|gn_bwd", mangled)
                        and re.search(r"[1-9]\d* bytes spill", line)):
                    spills.append(kernel)
    if spills:
        raise AssertionError(f"flash kernels or the GroupNorm backward "
                             f"spill: {spills}")
    if serialized:
        raise AssertionError(f"ptxas serialized the wgmma of {serialized} "
                             f"(C75xx)")
    for lib, names in HOPPER_KERNELS.items():
        counts = sass_counts(libs[lib])
        for name in names:
            hgmma, utmaldg = counts.get(name, (0, 0))
            log(f"[build] {lib} SASS {name}: {hgmma} HGMMA, {utmaldg} "
                "UTMALDG or UBLKCP")
            if not (hgmma and utmaldg):
                raise AssertionError(f"{name} runs no wgmma or no TMA load: "
                                     f"{hgmma} HGMMA, {utmaldg} UTMALDG or "
                                     "UBLKCP")
    dq_at_once, dkv_at_once = d512_clusters()
    log(f"[build] flash_attn_bwd clusters of eight at once (the fp32 d = 512 "
        f"backward's rounds): flash_dq_d512 {dq_at_once}, flash_dkv_d512 "
        f"{dkv_at_once}")
    log(f"[wgmma] the card's rounding: {json.dumps(wgmma_probe.rounding())}")


def sass_counts(lib: Path) -> dict:
    """{kernel: (HGMMA, UTMALDG + UBLKCP)}: the warpgroup-product and TMA-load
    (tensor or bulk) instructions of each flash kernel in `cuobjdump -sass`
    of a library."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            m = re.search(r"\d(flash_(?:fwd|dq|dkv)_d\d+(?:_bf16)?)(?=[EI])",
                          fn[1])
            name = m[1] if m else None
            if name:
                counts.setdefault(name, [0, 0])
        elif name:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "UTMALDG" in line or "UBLKCP" in line
    return {k: tuple(v) for k, v in counts.items()}


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
    "rans_decode_lanes": device_rans.decode_pass,
    "rans_decode_shared": device_rans.decode_pass_shared,
    "rans_encode_lanes": device_rans.encode_lanes,
}


def reset_counters():
    for fn in KERNEL_FNS.values():
        fn.launches = 0
        fn.shapes = {}


def read_counters():
    """(launches, shapes) of every kernel wrapper since the last reset."""
    return ({k: fn.launches for k, fn in KERNEL_FNS.items()},
            {k: dict(fn.shapes) for k, fn in KERNEL_FNS.items()})


def run_process(model, img01, stream: Path, seed: int, sampler: str = "ddpm",
                guidance: float = 1.0):
    """One image through the CLI's per-image function; (uint8 image, bpp)."""
    gen = torch.Generator(device=img01.device).manual_seed(seed)
    return process(model, img01, STEPS, str(stream), gen, sampler, guidance)


def run_stages(model, img01, stream: Path, seed: int, sampler: str = "ddpm",
               guidance: float = 1.0):
    """The three pipeline calls process() makes, timed one by one."""
    h, w = img01.shape[1:3]
    gen = torch.Generator(device=img01.device).manual_seed(seed)
    _, t_c = host_ms(lambda: model.apply_condition_compress(img01, stream, h, w))
    (c_latent, guide_hint), t_d = host_ms(
        lambda: model.apply_condition_decompress(stream))
    out, t_s = host_ms(lambda: model.decode_pipeline(
        c_latent, guide_hint, STEPS, sampler=sampler, guidance_scale=guidance,
        generator=gen))
    ms = {"encode_and_compress": t_c, "decompress": t_d,
          "relay_sample_and_vae_decode": t_s}
    return c_latent, guide_hint, out, ms


def serve_launches(model, guidance: float = 1.0) -> dict:
    """Kernel launches of one 768x512 image, from the model's structure:
    14 self-attentions over >= 1024 tokens per denoiser call (UNet 5 + 5,
    control 2 + 2), plus the two VAE mid-blocks; one launch per GroupNorm32
    call. Under classifier-free guidance each step also runs the base UNet
    alone: 10 more flash launches and one more per base GroupNorm32. No
    training kernel (no grad on this path)."""
    den = model.denoiser
    n_gn = sum(isinstance(m, GroupNorm32) for m in den.modules())
    n_gn_base = sum(isinstance(m, GroupNorm32) for m in den.base.modules())
    cfg = 1 if guidance != 1.0 else 0
    want = dict.fromkeys(KERNEL_FNS, 0)
    want.update({
        "flash_attn_fwd": (FLASH_PER_DENOISER_CALL_768
                           + cfg * FLASH_PER_BASE_CALL_768) * STEPS + 2,
        "group_norm_silu_fwd": (n_gn + cfg * n_gn_base) * STEPS})
    return want


def phase_main_path(model, device, seed: int, tag: str = "main",
                    sampler: str = "ddpm", guidance: float = 1.0) -> dict:
    """process() on a synthetic 768x512 image: a warm-up, a counted run
    and a staged run, with the checks of phase 3 (see the module's
    docstring)."""
    rng = np.random.default_rng(seed)
    img01 = torch.from_numpy(
        rng.uniform(size=(1, *IMAGE_HW, 3)).astype(np.float32)).to(device)
    opts = dict(sampler=sampler, guidance=guidance)
    with tempfile.TemporaryDirectory() as tmp:
        stream = Path(tmp) / "image.rdeic"
        (warm_img, _), warm_ms = host_ms(
            lambda: run_process(model, img01, stream, seed, **opts))
        streams = [stream.read_bytes()]
        reset_counters()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (img, bpp), ms = host_ms(
            lambda: run_process(model, img01, stream, seed, **opts))
        peak = torch.cuda.max_memory_allocated()
        launches, shapes = read_counters()
        streams.append(stream.read_bytes())
        c_latent, guide_hint, out, stage_ms = run_stages(
            model, img01, stream, seed, **opts)
        streams.append(stream.read_bytes())
    log(f"[{tag}] {sampler}, guidance {guidance:g}, "
        f"{str(model.denoiser.base.out_conv.weight.dtype).removeprefix('torch.')}"
        f": warm-up process() {warm_ms:.1f} ms")
    log(f"[{tag}] image {IMAGE_HW[1]}x{IMAGE_HW[0]}: {len(streams[0])} bytes, "
        f"bpp={bpp:.5f}; process() {ms:.1f} ms; "
        f"stage ms: {json.dumps(stage_ms)}; peak memory {peak / 2**30:.3f} GiB "
        f"({(peak - resident) / 2**30:.3f} above the {resident / 2**30:.3f} "
        "GiB resident before the run)")
    log(f"[{tag}] launches: {json.dumps(launches)}")
    if any(b != streams[0] for b in streams):
        raise AssertionError(f"[{tag}] the same image coded to different streams")
    if not np.array_equal(img, warm_img):
        raise AssertionError(f"[{tag}] process() gave two different images")
    # the encoder's own synthesis of the decoded slices, from the same feature
    with torch.no_grad():
        _, feature = model.encode_first_stage(img01 * 2 - 1)
        enc_latent, enc_hint = model.codec().compress(feature)["latents"]
    if not (torch.equal(c_latent, enc_latent)
            and torch.equal(guide_hint, enc_hint)):
        raise AssertionError(f"[{tag}] decoded latents differ from the encoder's")
    if tuple(out.shape) != (1, *IMAGE_HW, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"[{tag}] bad output {tuple(out.shape)}")
    if not np.array_equal(img, to_uint8(out[0].cpu().numpy())):
        raise AssertionError(f"[{tag}] process() and the staged calls disagree")
    want = serve_launches(model, guidance)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}")
    return {"bpp": bpp, "ms": ms, "stage_ms": stage_ms, "launches": launches,
            "shapes": shapes, "peak_bytes": peak, "resident_bytes": resident,
            "stream": streams[0], "latents": (c_latent, guide_hint),
            "image": out}


def make_bf16_model(model) -> RDEIC:
    """A bf16 serving copy of `model`: its tensors loaded onto a `meta`
    model, then `set_compute_dtype(torch.bfloat16)`, which makes new bf16
    tensors of the VAE, the denoiser and the context and leaves `model`'s
    fp32; the compression model and the codebook usage stay fp32, shared."""
    bf16 = RDEIC(**MODEL_CONFIG, device="meta").eval()
    bf16.load_state_dict(model.state_dict(), assign=True)
    bf16.set_compute_dtype(torch.bfloat16)
    return bf16


def phase_serve_options(model, device, seed: int) -> tuple[dict, RDEIC]:
    """Phase 3b: the serving path with the CLI's other flags, each run as
    phase 3's: DDIM, classifier-free guidance at 2.0 (DDPM) and bf16 (DDPM)
    on a bf16 copy of the model. ({path: run}, the bf16 model)."""
    runs = {"serve_ddim": phase_main_path(model, device, seed, "ddim",
                                          sampler="ddim"),
            "serve_cfg": phase_main_path(model, device, seed, "cfg",
                                         guidance=CFG_SCALE)}
    bf16 = make_bf16_model(model)
    runs["serve_bf16"] = phase_main_path(bf16, device, seed, "bf16")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("[bf16] the fp32 model's weights changed dtype")
    for name in ("flash_attn_fwd", "group_norm_silu_fwd"):
        dtypes = {k[-1] for k in runs["serve_bf16"]["shapes"][name]}
        if dtypes != {"bfloat16"}:
            raise AssertionError(f"[bf16] {name} ran in {dtypes}")
    # the bf16 run's stream, decoded by the fp32 model: the same latents
    with tempfile.TemporaryDirectory() as tmp:
        stream = Path(tmp) / "bf16.rdeic"
        stream.write_bytes(runs["serve_bf16"]["stream"])
        fp32_latents = model.apply_condition_decompress(stream)
    if not all(torch.equal(a, b) for a, b in
               zip(fp32_latents, runs["serve_bf16"]["latents"])):
        raise AssertionError("[bf16] the fp32 model decodes the bf16 run's "
                             "stream to other latents")
    log("[bf16] flash and GroupNorm ran in bf16 only; the fp32 model decodes "
        "the bf16 run's stream to the same latents, bit for bit")
    return runs, bf16


def partition_images(seed: int) -> list:
    """PARTITION_SIZES synthetic uint8 images, each a multiple of 64 a side
    (the padded size the CLI groups by)."""
    rng = np.random.default_rng(seed + 11)
    return [(f"img{i}", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for i, (h, w) in enumerate(PARTITION_SIZES)]


def partition_launches(model, chunks) -> list:
    """Each chunk's kernel launches from the model's structure: the VAE
    encoder's mid-block attention once on the whole chunk (flash, L >= 1024
    at both padded sizes); then per micro-batch of the sampler, 14 flash
    self-attentions per dual-UNet call (L = 6144 and 1536 at 768x512, 4096
    and 1024 at 512x512; the third level's L = 384 or 256 goes to the plain
    product) and the VAE decoder's mid-block, and one launch per
    GroupNorm32 call. The VAE's own norms are `F.group_norm`."""
    n_gn = sum(isinstance(m, GroupNorm32) for m in model.denoiser.modules())
    out = []
    for chunk in chunks:
        micros = -(-len(chunk) // PARTITION_MICRO)
        want = dict.fromkeys(KERNEL_FNS, 0)
        want.update({
            "flash_attn_fwd": 1 + micros * (FLASH_PER_DENOISER_CALL_768 * STEPS + 1),
            "group_norm_silu_fwd": micros * n_gn * STEPS})
        out.append(want)
    return out


def run_partition(model, chunks, stream_dir: Path, seed: int, context_fn=None,
                  replicas=()):
    """rdeic_torch.inference_partition's `serve` over `chunks`: the codec
    stage in its worker thread one chunk ahead, sampling in micro-batches
    from a generator seeded with `seed` (over `replicas` when given, as
    `--dp` serves). Returns [(out, bpps)] per chunk."""
    gen = torch.Generator(device=model.uncond_context.device).manual_seed(seed)
    outs = []
    for chunk, out, bpps, _ in serve(model, chunks, stream_dir, steps=STEPS,
                                     micro=PARTITION_MICRO, generator=gen,
                                     context_fn=context_fn,
                                     batch_size=PARTITION_BATCH,
                                     replicas=replicas):
        outs.append((out, bpps))
    return outs


def phase_partition(model, device, seed: int, tag: str,
                    context_fn=None) -> dict:
    """Phase 3c: batched serving through the CLI's chunk functions, one
    warm-up run then one counted run, each with the codec stage in its
    worker thread; then each chunk again stage by stage (serially, under
    the same numerics flags), timed. Checks: every stream file the same in
    both runs and equal to the single-image `apply_condition_compress` of
    that image; `decompress_batch` of a chunk bit-equal, row by row, to
    `decompress` of each stream alone; each reconstruction equal to
    `decode_pipeline` of its micro-batch with the same noise (and the same
    context); every output finite, [B, H, W, 3]; the launches of the whole
    run as the chunks' structure says (`partition_launches`)."""
    items = partition_images(seed)
    chunks = make_chunks(items, PARTITION_BATCH)
    n_img = len(items)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: Path(tmp) / k for k in ("warm", "counted", "single",
                                           "staged")}
        for d in dirs.values():
            d.mkdir()
        (_, warm_ms) = host_ms(lambda: run_partition(
            model, chunks, dirs["warm"], seed, context_fn))
        reset_counters()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs, ms = host_ms(lambda: run_partition(
            model, chunks, dirs["counted"], seed, context_fn))
        peak = torch.cuda.max_memory_allocated()
        launches, shapes = read_counters()
        streams = {name: (dirs["counted"] / f"{name}.rdeic").read_bytes()
                   for name, _ in items}
        for name, _ in items:
            if (dirs["warm"] / f"{name}.rdeic").read_bytes() != streams[name]:
                raise AssertionError(f"[{tag}] {name}: two runs wrote two "
                                     "streams")
        # each image alone through the single-image route
        for name, arr in items:
            img01 = torch.from_numpy(arr.astype(np.float32) / 255.0)[None].to(device)
            path = dirs["single"] / f"{name}.rdeic"
            model.apply_condition_compress(img01, path, *arr.shape[:2])
            if path.read_bytes() != streams[name]:
                raise AssertionError(f"[{tag}] {name}: the batched stream "
                                     "differs from the single-image one")
        # stage by stage, serially, with the same generator and flags
        gen = torch.Generator(device=device).manual_seed(seed)
        stage_ms = {"codec": 0.0, "sampling": 0.0}
        latents = {}
        with full_fp32(deterministic=True):
            for ci, (chunk, (out, _)) in enumerate(zip(chunks, outs)):
                paths = [dirs["staged"] / f"{n}.rdeic" for n, _ in chunk]
                imgs01 = torch.from_numpy(np.stack([a for _, a in chunk]).astype(
                    np.float32) / 255.0).to(device)
                _, t_e = host_ms(lambda: model.apply_condition_compress_batch(
                    imgs01, paths))
                (c_latent, guide_hint), t_c = host_ms(
                    lambda: model.apply_condition_decompress_batch(paths))
                stage_ms["codec"] += t_e + t_c
                for i, (name, _) in enumerate(chunk):
                    if paths[i].read_bytes() != streams[name]:
                        raise AssertionError(f"[{tag}] {name}: the serial "
                                             "codec stage wrote another stream")
                    alone = model.apply_condition_decompress(paths[i])
                    latents[name] = alone
                    if not (torch.equal(c_latent[i:i + 1], alone[0])
                            and torch.equal(guide_hint[i:i + 1], alone[1])):
                        raise AssertionError(f"[{tag}] {name}: decompress_"
                                             "batch differs from decompress "
                                             "alone")
                context = context_fn(chunk) if context_fn is not None else None

                def sample():
                    return torch.cat([model.decode_pipeline(
                        c_latent[j:j + PARTITION_MICRO],
                        guide_hint[j:j + PARTITION_MICRO], STEPS,
                        context=(None if context is None
                                 else context[j:j + PARTITION_MICRO]),
                        generator=gen)
                        for j in range(0, len(chunk), PARTITION_MICRO)])

                want, t_s = host_ms(sample)
                stage_ms["sampling"] += t_s
                h, w = chunk[0][1].shape[:2]
                if out.shape != (len(chunk), h, w, 3) or not np.isfinite(out).all():
                    raise AssertionError(f"[{tag}] chunk {ci}: output "
                                         f"{out.shape}")
                if not np.array_equal(out, want.float().cpu().numpy()):
                    raise AssertionError(f"[{tag}] chunk {ci}: the served "
                                         "images differ from decode_pipeline "
                                         "of each micro-batch")
    per_chunk = partition_launches(model, chunks)
    want = {k: sum(c[k] for c in per_chunk) for k in KERNEL_FNS}
    sizes = [f"{len(c)}x{c[0][1].shape[1]}x{c[0][1].shape[0]}" for c in chunks]
    log(f"[{tag}] chunks {sizes} (batch {PARTITION_BATCH}, micro "
        f"{PARTITION_MICRO}): warm-up {warm_ms:.1f} ms; counted run "
        f"{ms:.1f} ms, {ms / n_img:.1f} ms an image (host clock, "
        f"synchronised; codec of chunk k + 1 in its thread beside the "
        f"sampling of chunk k); staged serially: codec "
        f"{stage_ms['codec'] / n_img:.1f} and sampling "
        f"{stage_ms['sampling'] / n_img:.1f} ms an image; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} above the "
        f"{resident / 2**30:.3f} GiB resident); "
        f"{sum(len(b) for b in streams.values())} stream bytes")
    log(f"[{tag}] launches {json.dumps(launches)}; per chunk from the "
        f"structure {json.dumps(per_chunk)}")
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}")
    log(f"[{tag}] every stream equals the single-image one and the serial "
        "codec stage's, every decompress_batch row the stream decoded alone, "
        "every image decode_pipeline's, bit for bit")
    return {"ms": ms, "ms_per_image": ms / n_img, "stage_ms": stage_ms,
            "launches": launches, "shapes": shapes, "peak_bytes": peak,
            "streams": streams, "latents": latents,
            "images": [out for out, _ in outs]}


def check_partition_bf16(model, runs) -> None:
    """The bf16 partition run: flash ran in bf16 only and no GroupNorm call
    was all fp32; its streams (from the bf16 VAE encoder's feature, coded
    by the fp32 compression model) decode on the fp32 model to the latents
    the bf16 model decodes them to."""
    run = runs["partition_bf16"]
    flash = {k[-1] for k in run["shapes"]["flash_attn_fwd"]}
    gn_fp32 = [k for k in run["shapes"]["group_norm_silu_fwd"]
               if k[-1] == k[-2] == "float32"]
    if flash != {"bfloat16"} or gn_fp32:
        raise AssertionError(f"[partition_bf16] flash ran in {flash}; "
                             f"GroupNorm all fp32 at {gn_fp32}")
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in run["streams"].items():
            path = Path(tmp) / f"{name}.rdeic"
            path.write_bytes(data)
            got = model.apply_condition_decompress(path)
            if not all(torch.equal(a, b)
                       for a, b in zip(got, run["latents"][name])):
                raise AssertionError(f"[partition_bf16] {name}: the fp32 "
                                     "model decodes the bf16 stream to "
                                     "other latents")
    log("[partition_bf16] flash ran in bf16 only; the fp32 model decodes the "
        "bf16 streams to the bf16 run's latents, bit for bit")


def clip_tokenizer(tmp: Path) -> SimpleTokenizer:
    """The byte-BPE tokenizer over a small merges file written here (the
    published vocabulary is not in the repository)."""
    path = tmp / "bpe_simple_vocab.txt.gz"
    with gzip.open(path, "wb") as f:
        f.write(("merges\n" + "\n".join(PARTITION_MERGES) + "\n").encode())
    return SimpleTokenizer(str(path))


def phase_partition_clip(model, device, seed: int) -> None:
    """Phase 3c with captions: a full-width CLIP text tower (random weights
    from `seed`) attached to the fp32 model conditions the sampler on the
    CLIP context of each image's caption. The tower against a CPU copy of
    it on the same tokens (CLIP_REF_TOL, beside a planted x1.05 fault),
    then the batched serving run and its checks with that context."""
    torch.manual_seed(seed + 5)
    clip = model.attach_clip()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tok = clip_tokenizer(Path(tmp))
        tokens = torch.from_numpy(tok.tokenize(PARTITION_CAPTIONS))
        got, ms = host_ms(lambda: model.get_learned_conditioning(
            len(PARTITION_CAPTIONS), tokens.to(device)))
        with torch.device("meta"):
            cpu = OpenCLIPTextEncoder(width=MODEL_CONFIG["control_stage_config"]
                                      ["params"]["context_dim"])
        cpu.load_state_dict({k: v.cpu() for k, v in clip.state_dict().items()},
                            assign=True)
        with torch.no_grad():
            want = cpu(tokens)
        r = compare_rel("[partition_clip] CLIP card vs CPU",
                        [(got.cpu(), want, CLIP_REF_TOL)])
        log(f"[partition_clip] CLIP tower ({sum(p.numel() for p in clip.parameters()) / 1e6:.0f}"
            f" M params, {clip.n_blocks} blocks) on {len(PARTITION_CAPTIONS)}"
            f" captions: {ms:.1f} ms on the card; card vs CPU "
            f"{json.dumps(r)}")
        prompts = dict(zip((n for n, _ in partition_images(seed)),
                           PARTITION_CAPTIONS))

        def context_fn(chunk):
            t = torch.from_numpy(tok.tokenize([prompts[n] for n, _ in chunk]))
            return model.get_learned_conditioning(len(chunk), t.to(device))

        phase_partition(model, device, seed, "partition_clip", context_fn)
    finally:
        del model.clip


def check_launches(tag: str, launches: dict, want: dict) -> None:
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}")


@contextlib.contextmanager
def rans_settings(model, settings: dict):
    """The block runs under these RDEIC_RANS_* settings (none of the
    process's own), with the model's codec built anew under them, as a
    process started with them builds it; both are restored after."""
    old = {k: os.environ.pop(k) for k in list(os.environ)
           if k.startswith("RDEIC_RANS_")}
    os.environ.update(settings)
    model._codec = None
    try:
        yield model.codec()
    finally:
        for k in [k for k in os.environ if k.startswith("RDEIC_RANS_")]:
            del os.environ[k]
        os.environ.update(old)
        model._codec = None


def tiled_image(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 17)
    return rng.uniform(size=(1, *TILED_HW, 3)).astype(np.float32)


def lane_containers(strings, v2: bool) -> list:
    """The codec containers of a tiled stream's strings: the whole
    image's (v2), or each tile's (v1)."""
    if v2:
        return [strings[1:]]
    meta = strings[0][0]
    n = int(np.prod(struct.unpack(tiled.META_FMT, meta)[4:]))
    gs = (len(strings) - 1) // n
    return [strings[1 + gs * i:1 + gs * (i + 1)] for i in range(n)]


def rans_launches(containers, min_lanes: int = 32) -> dict:
    """Decode launches of the lane kernels for these codec containers, each
    decoded in calls of its own: a launch a pass (two a slice) for each
    lanes container the card decodes (v1, or v2 at K >= min_lanes); none
    for two-group containers or v2 below min_lanes (the host decodes
    those)."""
    want = {"rans_decode_lanes": 0, "rans_decode_shared": 0}
    for c in containers:
        if len(c) == 3:
            ver, k, _ = parse_lane_header(c[2][0])
            if ver == 1:
                want["rans_decode_lanes"] += 2 * SLICES
            elif k >= min_lanes:
                want["rans_decode_shared"] += 2 * SLICES
    return want


def tiled_launches(model, v2: bool, n_tiles: int, tile_batch: int,
                   containers) -> dict:
    """Kernel launches of one tiled run from the grid's structure: the VAE
    encoder's mid-block attention once a feature call (v2: a call per
    FEATURE_BATCH tiles; v1: a call a tile; L = 4096 at a 512 tile); per
    tile batch, 14 flash self-attentions per dual-UNet call (L = 4096 and
    1024 at 64x64 latents) and the VAE decoder's mid-block, and one launch
    per GroupNorm32 call; the lane kernels a pass of each container the
    card decodes."""
    n_gn = sum(isinstance(m, GroupNorm32) for m in model.denoiser.modules())
    batches = len(tiled.tile_batches(n_tiles, tile_batch))
    features = -(-n_tiles // tiled.FEATURE_BATCH) if v2 else n_tiles
    want = dict.fromkeys(KERNEL_FNS, 0)
    want.update({
        "flash_attn_fwd": features + batches * (
            FLASH_PER_DENOISER_CALL_512 * STEPS + 1),
        "group_norm_silu_fwd": batches * n_gn * STEPS,
        **rans_launches(containers)})
    return want


def numpy_blend(tiles: np.ndarray, ys, xs, tile, overlap, ph, pw, H, W):
    """The plain NumPy blend (rdeic_tpu/pipeline/tiled.py `_blend_tiles`)."""
    weight = tiled._blend_weight(tile, overlap)
    acc = np.zeros((ph, pw, 3), np.float32)
    wacc = np.zeros((ph, pw, 1), np.float32)
    k = 0
    for y0 in ys:
        for x0 in xs:
            acc[y0:y0 + tile, x0:x0 + tile] += tiles[k] * weight
            wacc[y0:y0 + tile, x0:x0 + tile] += weight
            k += 1
    return (acc / np.maximum(wacc, 1e-8))[None, :H, :W]


def encoder_tile_latents(model, img: np.ndarray, v2: bool, grid):
    """What the encoder side synthesises for the tiles, with its streams:
    v2, the codec on the stitched feature map, its latents cut into the
    decode's latent tiles; v1, each tile's own codec call."""
    codec = model.codec()
    ys, xs, tile, overlap, ph, pw = grid
    if v2:
        h_full = tiled.stitched_feature(model, img, TILE, OVERLAP)[0]
        out = codec.compress(h_full)
        f = model.latent_factor
        lt = tile // f
        cl, gh = out["latents"]
        cut = [(y0 // f, x0 // f) for y0 in ys for x0 in xs]
        return ([out["strings"]],
                torch.cat([cl[:, y:y + lt, x:x + lt] for y, x in cut]),
                torch.cat([gh[:, y:y + lt, x:x + lt] for y, x in cut]))
    padded = np.pad(img, ((0, 0), (0, ph - img.shape[1]),
                          (0, pw - img.shape[2]), (0, 0)))
    outs = [codec.compress(model.feature(torch.from_numpy(np.ascontiguousarray(
        padded[:, y0:y0 + tile, x0:x0 + tile])).to(model.uncond_context.device)))
        for y0 in ys for x0 in xs]
    return ([o["strings"] for o in outs],
            torch.cat([o["latents"][0] for o in outs]),
            torch.cat([o["latents"][1] for o in outs]))


def phase_tiled(model, device, seed: int, tag: str, v2: bool,
                tile_batch: int, settings: dict) -> dict:
    """Phase 3d: the tiled path through rdeic_torch.pipeline.tiled (the
    CLI's functions) on a synthetic TILED_HW image: a warm-up, a counted
    run, then each stage again, timed (compress, decompress, tile
    sampling, blend). Checks in the module's docstring."""
    img = tiled_image(seed)
    H, W = TILED_HW
    compress = tiled.tiled_compress_xctx if v2 else tiled.tiled_compress
    with rans_settings(model, settings) as codec, \
            tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / f"{k}.rdeic" for k in ("warm", "counted",
                                                    "staged")]

        def run(path):
            gen = torch.Generator(device=device).manual_seed(seed)
            bpp = compress(model, img, path, tile=TILE, overlap=OVERLAP)
            return tiled.tiled_decompress_decode(
                model, path, steps=STEPS, tile_batch=tile_batch,
                generator=gen), bpp

        (warm, _), warm_ms = host_ms(lambda: run(paths[0]))
        reset_counters()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (out, bpp), ms = host_ms(lambda: run(paths[1]))
        peak = torch.cuda.max_memory_allocated()
        launches, shapes = read_counters()
        # staged, with a generator seeded alike
        gen = torch.Generator(device=device).manual_seed(seed)
        _, t_enc = host_ms(lambda: compress(model, img, paths[2], tile=TILE,
                                            overlap=OVERLAP))
        strings, zshape = tiled.read_tiled(paths[2])
        lat, t_dec = host_ms(lambda: tiled.decode_tile_latents(
            model, strings, zshape))
        cl, gh, ys, xs, tile, overlap, ph, pw, _, _ = lat
        n_tiles = cl.shape[0]
        tiles, t_samp = host_ms(lambda: torch.cat([
            model.decode_pipeline(cl[a:b], gh[a:b], STEPS, generator=gen)
            for a, b in tiled.tile_batches(n_tiles, tile_batch)]))
        # the served route's tiles, from a generator seeded alike
        served = tiled._batched_tile_decode(
            model, cl, gh, STEPS, "ddpm", tile_batch, None,
            torch.Generator(device=device).manual_seed(seed))
        blend, t_blend = host_ms(lambda: tiled._blend_tiles(
            tiles, ys, xs, tile, overlap, ph, pw, H, W))
        streams = [p.read_bytes() for p in paths]
        containers = lane_containers(strings, v2)
        enc_strings, enc_cl, enc_gh = encoder_tile_latents(
            model, img, v2, (ys, xs, tile, overlap, ph, pw))
        # the first tile the card decodes: its passes again, each against
        # the plain version and the host coder
        passes = {}
        for c in containers:
            ver, k, _ = (parse_lane_header(c[2][0]) if len(c) == 3
                         else (0, 0, None))
            if ver == 1 or (ver == 2 and k >= codec.device_min_lanes):
                one = [{"strings": c, "shape": zshape}]
                name = "decode_pass" if ver == 1 else "decode_pass_shared"
                with _PassSpy(name) as spy:
                    codec.decompress_batch(one)
                passes = check_passes(f"{tag}, a tile", spy, one, codec.table,
                                      host=True)
                break
    stage_ms = {"compress": t_enc, "decompress": t_dec,
                "tile_sampling": t_samp, "blend": t_blend}
    want = tiled_launches(model, v2, n_tiles, tile_batch, containers)
    mpx = H * W / 1e6
    dtype = str(compute_dtype(model)).removeprefix("torch.")
    lanes = sorted({parse_lane_header(c[2][0])[:2] for c in containers
                    if len(c) == 3})
    log(f"[{tag}] {'v2 cross-tile' if v2 else 'v1 independent tiles'}, "
        f"{dtype}, {W}x{H} image, tile {TILE}, overlap {OVERLAP}, "
        f"{n_tiles} tiles, tile_batch {tile_batch}, settings "
        f"{json.dumps(settings)}, lanes containers (version, K) {lanes}: "
        f"warm-up {warm_ms:.1f} ms; counted run {ms:.1f} ms an image, "
        f"{ms / mpx:.1f} ms per megapixel; bpp={bpp:.5f} ({len(streams[1])} "
        f"bytes); staged ms {json.dumps(stage_ms)}; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} above the "
        f"{resident / 2**30:.3f} GiB resident)")
    log(f"[{tag}] launches {json.dumps(launches)}; from the grid "
        f"{json.dumps(want)}")
    if any(b != streams[0] for b in streams):
        raise AssertionError(f"[{tag}] the image coded to different streams")
    if [list(c) for c in containers] != [list(c) for c in enc_strings]:
        raise AssertionError(f"[{tag}] the stream's codec groups differ from "
                             "the codec's on the encoder's features")
    if not (torch.equal(cl, enc_cl) and torch.equal(gh, enc_gh)):
        raise AssertionError(f"[{tag}] decoded latents differ from the "
                             "encoder's synthesis")
    if tuple(out.shape) != (1, H, W, 3) or not torch.isfinite(out).all() \
            or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"[{tag}] bad output {tuple(out.shape)}")
    if not torch.equal(served, tiles):
        raise AssertionError(f"[{tag}] a served tile differs from "
                             "decode_pipeline of its tile batch")
    if not (torch.equal(out, warm) and torch.equal(out, blend)):
        raise AssertionError(f"[{tag}] the served image differs from the "
                             "warm-up's or from the staged tiles' blend")
    want_blend = numpy_blend(tiles.float().cpu().numpy(), ys, xs, tile,
                             overlap, ph, pw, H, W)
    blend_err = float(np.abs(blend.cpu().numpy() - want_blend).max())
    if blend_err > 1e-6:
        raise AssertionError(f"[{tag}] blend vs NumPy {blend_err:.3g}")
    check_launches(tag, launches, want)
    if settings and not (want["rans_decode_lanes"]
                         or want["rans_decode_shared"]):
        raise AssertionError(f"[{tag}] no lanes container the card decodes "
                             f"under {settings}: {lanes}")
    if settings and not passes:
        raise AssertionError(f"[{tag}] no tile's passes were checked")
    log(f"[{tag}] streams equal across runs and to the codec's on the "
        f"encoder's features; latents the encoder's synthesis, each tile "
        f"decode_pipeline's of its tile batch and the image their blend, bit "
        f"for bit; blend vs NumPy {blend_err:.3g}"
        + (f"; a tile's {passes['passes']} kernel passes ({passes['symbols']}"
           f" symbols) equal the plain version's and the host coder's"
           if passes else ""))
    return {"ms": ms, "ms_per_mpx": ms / mpx, "bpp": bpp, "stage_ms": stage_ms,
            "launches": launches, "shapes": shapes, "peak_bytes": peak,
            "resident_bytes": resident, "n_tiles": n_tiles,
            "stream": streams[1], "image": out.cpu(),
            "containers": containers, "tile_batch": tile_batch}


class _PassSpy:
    """Records every call of a device_rans decode function (its inputs on
    the card, its outputs) while installed in the module's place."""

    def __init__(self, name: str):
        self.name, self.real, self.calls = name, getattr(device_rans, name), []

    def __call__(self, *args):
        out = self.real(*args)
        self.calls.append((args, out))
        return out

    def __enter__(self):
        setattr(device_rans, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(device_rans, self.name, self.real)


def check_passes(tag: str, spy: _PassSpy, outs: list, table,
                 host: bool) -> dict:
    """Each recorded pass of the kernel against the plain version on the
    same inputs (on the CPU), and, when `host`, against the host coder
    reading each image's stream: symbols, state and cursor equal."""
    cpu_tabs = device_rans.DeviceRansTables(table)
    plain = {"decode_pass": device_rans.decode_pass_plain,
             "decode_pass_shared": device_rans.decode_pass_shared_plain}[
                 spy.name]
    t_plain = 0.0
    coders = []
    if host:
        for o in outs:
            ver, k, nbytes = parse_lane_header(o["strings"][2][0])
            data = o["strings"][0][0]
            if ver == 2:
                coders.append(SharedRansDecoder(data, k))
            else:
                offs = np.concatenate([[0], np.cumsum(nbytes)])
                lanes = []
                for i in range(k):
                    d = RansDecoder()
                    d.set_stream(data[offs[i]:offs[i + 1]])
                    lanes.append(d)
                coders.append(lanes)
    n_sym, err = 0, 0
    for args, (sym, (state, ptr)) in spy.calls:
        _, *rest, n = args
        t0 = time.perf_counter()
        want_sym, (want_state, want_ptr) = plain(
            cpu_tabs, *(a.cpu() for a in rest), n)
        t_plain += time.perf_counter() - t0
        err = max([err] + [int((a.cpu().long() - b.long()).abs().max())
                           for a, b in ((sym, want_sym), (state, want_state),
                                        (ptr, want_ptr))])
        if err:
            raise AssertionError(f"[{tag}] {spy.name}: the kernel differs from "
                                 f"the plain version by up to {err}")
        idx = rest[-1].cpu().numpy()
        for b, coder in enumerate(coders):
            ix = idx[b, :n]
            if isinstance(coder, list):
                k = len(coder)
                host_sym = np.zeros(n, np.int32)
                for lane in range(min(k, n)):
                    host_sym[lane::k] = coder[lane].decode_stream(
                        ix[lane::k], table)
            else:
                host_sym = coder.decode_pass(ix, table)
            if not np.array_equal(sym[b, :n].cpu().numpy(), host_sym):
                raise AssertionError(f"[{tag}] {spy.name}: the kernel differs "
                                     "from the host coder")
        n_sym += n * sym.shape[0]
    for coder in coders:
        for d in (coder if isinstance(coder, list) else [coder]):
            d.close()
    return {"passes": len(spy.calls), "symbols": n_sym,
            "plain_ms": t_plain * 1e3, "max_abs_err": err}


def check_encode(tag: str, spy: _PassSpy, table) -> dict:
    """The recorded encode launch against the plain version on the same
    inputs (on the CPU): words, counts and the overflow flag equal."""
    (args, got), = spy.calls
    tabs, *steps, wcap = args
    t0 = time.perf_counter()
    want = device_rans.encode_lanes_plain(
        device_rans.DeviceRansTables(table), *(s.cpu() for s in steps), wcap)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((a.cpu().long() - b.long()).abs().max())
              for a, b in zip(got, want))
    if err:
        raise AssertionError(f"[{tag}] encode_lanes: the kernel differs from "
                             f"the plain version by up to {err}")
    # the planted fault reads: one symbol changed changes the words
    bad = steps[0].clone()
    bad[0, 0, 0] += 1
    if torch.equal(device_rans.encode_lanes(tabs, bad, *steps[1:], wcap)[0],
                   got[0]):
        raise AssertionError(f"[{tag}] encode_lanes: a changed symbol left "
                             "the words as they were")
    return {"steps": int(steps[0].shape[0]), "plain_ms": plain_ms,
            "max_abs_err": err}


def lane_images(seed: int) -> np.ndarray:
    """Phase 3's image first, then LANE_BATCH - 1 more at its size."""
    first = np.random.default_rng(seed).uniform(size=(1, *IMAGE_HW, 3))
    rest = np.random.default_rng(seed + 23).uniform(
        size=(LANE_BATCH - 1, *IMAGE_HW, 3))
    return np.concatenate([first, rest]).astype(np.float32)


def phase_lanes(model, device, seed: int, base: dict) -> dict:
    """Phase 3e: the lane codec's routes (LANE_ROUTES, each under
    RDEIC_RANS_OVERHEAD_PCT=0 so K holds) through the model's entry points
    on phase 3's 768x512 image (the batch route on LANE_BATCH images),
    each a warm-up then a counted compress + decompress; then the passes
    again under a spy, each against the plain version and the host coder,
    and a corrupt stream. Returns {route: run}."""
    imgs = torch.from_numpy(lane_images(seed)).to(device)
    h, w = IMAGE_HW
    with torch.no_grad():
        feats = [model.feature(imgs[i:i + 1]) for i in range(LANE_BATCH)]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, settings in LANE_ROUTES.items():
            batch = tag == "lanes_batch"
            n = LANE_BATCH if batch else 1
            paths = [Path(tmp) / f"{tag}_{i}.rdeic" for i in range(n)]
            with rans_settings(model, {**settings,
                                       "RDEIC_RANS_OVERHEAD_PCT": "0"}) as codec:
                def run():
                    if batch:
                        bpps = model.apply_condition_compress_batch(imgs, paths)
                        return bpps, model.apply_condition_decompress_batch(
                            paths)
                    bpp = model.apply_condition_compress(imgs[:1], paths[0],
                                                         h, w)
                    return [bpp], model.apply_condition_decompress(paths[0])

                run()
                warm = [p.read_bytes() for p in paths]
                reset_counters()
                routes0 = dict(codec.host_routes)
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bpps = (model.apply_condition_compress_batch(imgs, paths)
                        if batch else [model.apply_condition_compress(
                            imgs[:1], paths[0], h, w)])
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                latents = (model.apply_condition_decompress_batch(paths)
                           if batch else
                           model.apply_condition_decompress(paths[0]))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                peak = torch.cuda.max_memory_allocated()
                launches, shapes = read_counters()
                host_routes = {k: v - routes0[k]
                               for k, v in codec.host_routes.items()}
                streams = [p.read_bytes() for p in paths]
                outs = [dict(zip(("strings", "shape"), tiled.read_tiled(p)))
                        for p in paths]
                # the passes again, each against the plain version and the
                # host coder; then a corrupt stream
                checks = {}
                ver, k, _ = parse_lane_header(outs[0]["strings"][2][0])
                card = ver == 1 or k >= codec.device_min_lanes
                if card:
                    name = "decode_pass" if ver == 1 else "decode_pass_shared"
                    with _PassSpy(name) as spy:
                        codec.decompress_batch(outs)
                    checks = check_passes(tag, spy, outs, codec.table,
                                          host=True)
                    checks["calls"] = spy.calls
                    bad = [dict(o) for o in outs]
                    data = bytearray(bad[0]["strings"][0][0])
                    data[len(data) // 2] ^= 0x5A
                    bad[0]["strings"] = [[bytes(data)]] + bad[0]["strings"][1:]
                    with _PassSpy(name) as bad_spy:
                        codec.decompress_batch(bad)
                        torch.cuda.synchronize()
                    check_passes(tag + ", a corrupt stream", bad_spy, bad,
                                 codec.table, host=False)
                    # the planted fault reads: the flipped byte changes the
                    # kernel's symbols
                    if all(torch.equal(a[1][0], b[1][0])
                           for a, b in zip(spy.calls, bad_spy.calls)):
                        raise AssertionError(f"[{tag}] a flipped byte left "
                                             "every pass's symbols as they "
                                             "were")
                if codec.device_enc:
                    with _PassSpy("encode_lanes") as spy:
                        codec.compress(feats[0])
                    checks["encode"] = check_encode(tag, spy, codec.table)
                    checks["encode_calls"] = spy.calls
                enc = [codec.compress(f)["latents"] for f in feats[:n]]
                overflow = codec.host_routes["encode_after_overflow"]
            want_latents = (torch.cat([e[0] for e in enc]),
                            torch.cat([e[1] for e in enc]))
            if not all(torch.equal(a, b) for a, b in zip(latents, want_latents)):
                raise AssertionError(f"[{tag}] decoded latents differ from the "
                                     "encoder's synthesis")
            if streams != warm:
                raise AssertionError(f"[{tag}] two runs, two streams")
            # the VAE encoder's mid-block attention: one flash launch
            want = dict.fromkeys(KERNEL_FNS, 0)
            want["flash_attn_fwd"] = 1
            # the batch decodes in one launch a pass
            want.update(rans_launches([outs[0]["strings"]]))
            if "RDEIC_RANS_DEVICE_ENC" in settings:
                want["rans_encode_lanes"] = 1
            check_launches(tag, launches, want)
            if tag == "lanes_v2_k16" and host_routes["shared_decode"] != 1:
                raise AssertionError(f"[{tag}] the host route did not run: "
                                     f"{host_routes}")
            if overflow:
                raise AssertionError(f"[{tag}] the device encoder overflowed")
            runs[tag] = {"bpp": float(np.mean(bpps)), "compress_ms": (t1 - t0) * 1e3,
                         "decompress_ms": (t2 - t1) * 1e3, "launches": launches,
                         "shapes": shapes, "host_routes": host_routes,
                         "peak_bytes": peak, "resident_bytes": resident,
                         "streams": streams, "version_k": (ver, k),
                         "checks": checks}
            log(f"[lanes] {tag} (settings {json.dumps(settings)}, overhead 0%,"
                f" {n} image{'s' if n > 1 else ''}): v{ver}, K = {k}, "
                f"{'card' if card else 'host'} decode; bpp "
                f"{np.mean(bpps):.5f}; compress {(t1 - t0) * 1e3:.1f} ms, "
                f"decompress {(t2 - t1) * 1e3:.1f} ms (phase 3's host route: "
                f"{base['stage_ms']['decompress']:.1f} ms with the file read); "
                f"launches {json.dumps({k_: v for k_, v in launches.items() if v})}"
                f"; host routes {json.dumps(host_routes)}; kernel vs plain "
                f"and host coder: "
                f"{json.dumps({k_: v for k_, v in checks.items() if k_ in ('passes', 'symbols', 'plain_ms')})}")
    if runs["lanes_device_enc"]["streams"] != runs["lanes_v1"]["streams"]:
        raise AssertionError("[lanes] the device encoder's stream differs from "
                             "rans_encode_interleaved's (the v1 route)")
    log("[lanes] every route decodes to the encoder's synthesis bit for bit; "
        "the device encoder's payload equals rans_encode_interleaved's, no "
        "overflow; every kernel pass equals the plain version and the host "
        "coder, a corrupt stream the plain version's; a flipped byte changes "
        "the kernels' symbols, a changed symbol the encoder's words")
    return runs


# -- the evaluation harnesses: phase 3f ------------------------------------------
HARNESS_IMAGES = 2  # baseline and run_ood images, 768x512
HARNESS_TTA = 2  # run_ood's --tta_samples
HARNESS_FIT = 4  # synthetic originals the NIQE and BRISQUE models fit on
HARNESS_NOISE = 0.05  # std of the noise NIQE must read as less natural
HARNESS_TARGETS = ["bitstream:random", "latent:additive"]
HARNESS_RATES, HARNESS_SEVERITIES, HARNESS_SEEDS = [0.0, 1e-3], [0.0, 0.1], [0]
# the lane route's sweep: v2 at K = 128, decoded by rans_decode_shared
HARNESS_LANE_SETTINGS = {"RDEIC_RANS_LANES": "128",
                         "RDEIC_RANS_OVERHEAD_PCT": "0"}
HARNESS_LANE_RATES, HARNESS_LANE_SEEDS = [0.0, 1e-3, 1e-2], [0, 1]
TRACE_TOP = 10  # device ops the trace's summary prints


def natural_image(seed: int, noise: float = 0.0) -> np.ndarray:
    """A synthetic 768x512 uint8 image with the smooth statistics NIQE and
    BRISQUE model (a Gaussian-blurred random field, stretched to [0, 1]),
    plus white noise of std `noise`."""
    from scipy.ndimage import gaussian_filter  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(size=(*IMAGE_HW, 3)), sigma=(3, 3, 0))
    img = (img - img.min()) / (img.max() - img.min())
    return to_uint8(np.clip(img + noise * rng.normal(size=img.shape), 0, 1))


def generator_noise(device, seed: int):
    """`noise()` of the harnesses: every draw from a generator seeded alike,
    so each decode gets process()'s noise for that seed."""
    return lambda: {"generator": torch.Generator(device=device).manual_seed(seed)}


def scaled_launches(want: dict, n: int) -> dict:
    """`want`'s launch counts, n runs of them."""
    return {k: v * n for k, v in want.items()}


def phase_harness(model, device, seed: int, serve: dict) -> dict:
    """Phase 3f, [harness]: the evaluation harnesses' per-image functions at
    full width on the card, with numpy images (the card's machine has no
    PIL). (a) baseline_inference's `process_single` on two synthetic
    768x512 images, each against process() with the same generator draws:
    stream and image bit-equal; ms an image, peak memory; (b) image_checker's
    rows on its outputs; (c) run_ood's `eval_image` at --tta_samples 2 with
    NIQE and BRISQUE self-fit (`nr_models`) on HARNESS_FIT synthetic
    originals: every score finite, NIQE reading a noised image as less
    natural than the clean one; (d) run_robustness's `sweep_image` on phase
    3's stream (cached as the clean stream), bitstream:random and
    latent:additive, every row with phase 3's noise: each severity-0 row
    phase 3's image bit for bit, the fail rate; then again on the lane
    route (v2, K = 128: rans_decode_shared on corrupted words), and a clean
    decode after both sweeps still phase 3's latents and image; (e)
    `device_trace` around one decode_pipeline: the trace file, the ten
    device ops that took longest, `memory_stats` against the allocator.
    Launches of each part against the structure; returns its runs."""
    suite = MetricSuite()
    fns = {n: suite.create_metric(n)
           for n in ("psnr", "ssim", "ms_ssim", "mse", "mae", "lpips")}
    per_image, per_decode = serve_launches(model), decode_launches(model)
    phase3 = to_uint8(serve["image"][0].cpu().numpy())
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) baseline
        refs = [natural_image(seed + 30 + i) for i in range(HARNESS_IMAGES)]
        base_fns = {n: fns[n] for n in baseline_inference.METRICS}
        reset_counters()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs, rows, ms = [], [], []
        for i, ref in enumerate(refs):
            gen = torch.Generator(device=device).manual_seed(seed + i)
            (out01, bpp, enc_t, dec_t), t = host_ms(
                lambda: baseline_inference.process_single(
                    model, ref, tmp / f"base{i}.rdeic", STEPS, generator=gen))
            ms.append(t)
            outs.append(to_uint8(out01))
            rows.append(baseline_inference.baseline_row(
                f"im{i}", bpp, enc_t, dec_t,
                score_images(base_fns, ref, outs[-1], device)))
        peak = torch.cuda.max_memory_allocated()
        launches, shapes = read_counters()
        runs["harness_baseline"] = {"launches": launches, "shapes": shapes}
        for i, ref in enumerate(refs):
            img01 = torch.from_numpy(to_float01(ref)[None]).to(device)
            want, _ = run_process(model, img01, tmp / "process.rdeic", seed + i)
            log(f"[harness] baseline im{i}: {json.dumps(rows[i])}")
            if not np.array_equal(outs[i], want):
                raise AssertionError(f"[harness] baseline im{i}: the image "
                                     "differs from process()'s")
            if ((tmp / f"base{i}.rdeic").read_bytes()
                    != (tmp / "process.rdeic").read_bytes()):
                raise AssertionError(f"[harness] baseline im{i}: the stream "
                                     "differs from process()'s")
            if not all(np.isfinite(rows[i][n]) for n in base_fns):
                raise AssertionError(f"[harness] baseline im{i}: {rows[i]}")
        log(f"[harness] baseline: {np.mean(ms):.1f} ms an image "
            f"({', '.join(f'{t:.1f}' for t in ms)}), peak memory "
            f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} above "
            f"the resident); streams and images bit-equal to process()'s "
            f"with the same generator; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        check_launches("harness baseline", launches,
                       scaled_launches(per_image, HARNESS_IMAGES))

        # (b) image_checker on the baseline's outputs
        check_fns = {n: fns[n] for n in image_checker.METRICS}
        checks = []
        for i, (ref, out) in enumerate(zip(refs, outs)):
            checks.append({"name": f"im{i}",
                           **score_images(check_fns, ref, out, device)})
            diff = image_checker.diff_image(ref, out)
            log(f"[harness] image_checker {json.dumps(checks[-1])}; |diff| "
                f"max {int(diff.max())}, mean {diff.mean():.3f}")
            if checks[-1]["psnr"] != rows[i]["psnr"]:
                raise AssertionError("[harness] image_checker's psnr differs "
                                     "from the baseline row's")
        log(f"[harness] image_checker averages: "
            f"{json.dumps(image_checker.averages(checks))}")

        # (c) run_ood
        t0 = time.perf_counter()
        models = run_ood.nr_models(None, None, (natural_image(seed + 40 + i)
                                                for i in range(HARNESS_FIT)))
        fit_s = time.perf_counter() - t0
        clean = natural_image(seed + 50)
        noisy = natural_image(seed + 50, noise=HARNESS_NOISE)
        nr = {n: [m.score(x.astype(np.float64) / 255.0) for x in (clean, noisy)]
              for n, m in models.items()}
        log(f"[harness] run_ood: NIQE and BRISQUE fit on {HARNESS_FIT} "
            f"synthetic originals in {fit_s:.2f} s; (clean, noised by "
            f"{HARNESS_NOISE}) scores {json.dumps(nr)}")
        if sorted(models) != ["brisque", "niqe"] or not nr["niqe"][0] < nr["niqe"][1]:
            raise AssertionError(f"[harness] run_ood: NIQE does not read the "
                                 f"noise: {nr}")
        ood_fns = {n: fns[n] for n in run_ood.METRICS}
        gen = torch.Generator(device=device).manual_seed(seed + 60)
        reset_counters()
        for i, ref in enumerate(refs):
            (row, _, pick), t = host_ms(lambda: run_ood.eval_image(
                model, ref, tmp / f"ood{i}.rdeic", STEPS, ood_fns, models,
                [{"generator": gen}] * HARNESS_TTA))
            log(f"[harness] run_ood im{i}: {json.dumps(row)}; kept draw "
                f"{pick} of {HARNESS_TTA}; {t:.1f} ms")
            if not all(np.isfinite(v) for v in row.values()):
                raise AssertionError(f"[harness] run_ood im{i}: {row}")
        launches, shapes = read_counters()
        runs["harness_ood"] = {"launches": launches, "shapes": shapes}
        want = scaled_launches(per_image, HARNESS_IMAGES)
        for k, v in per_decode.items():
            want[k] += v * HARNESS_IMAGES * (HARNESS_TTA - 1)
        check_launches("harness run_ood", launches, want)

        # (d) run_robustness: the host route, then the lane route
        (tmp / "clean.rdeic").write_bytes(serve["stream"])
        img01 = np.random.default_rng(seed).uniform(  # phase 3's input
            size=(1, *IMAGE_HW, 3)).astype(np.float32)
        ref = to_uint8(img01[0])  # the metrics' reference
        rob_fns = {n: fns[n] for n in run_robustness.METRICS}
        sweeps = {
            "harness_robustness": (
                {}, tmp / "clean.rdeic", HARNESS_TARGETS, HARNESS_RATES,
                HARNESS_SEEDS),
            "harness_robustness_lanes": (
                HARNESS_LANE_SETTINGS, tmp / "lanes.rdeic",
                ["bitstream:random"], HARNESS_LANE_RATES, HARNESS_LANE_SEEDS)}
        for tag, (settings, clean_stream, targets, rates, seeds) in sweeps.items():
            with rans_settings(model, settings) as codec:
                if settings:  # phase 3's image coded on the lane route
                    model.apply_condition_compress(
                        torch.from_numpy(img01).to(device), clean_stream,
                        *IMAGE_HW)
                host = codec.host_routes["shared_decode"]
                reset_counters()
                t0 = time.perf_counter()
                pairs = list(run_robustness.sweep_image(
                    model, ref, "im", clean_stream, tmp / "bad.rdeic", targets,
                    rates, HARNESS_SEVERITIES, seeds, STEPS, rob_fns,
                    generator_noise(device, seed)))
                sweep_s = time.perf_counter() - t0
                launches, shapes = read_counters()
                # a corrupt header's K below RDEIC_RANS_DEVICE_MIN_LANES
                # decodes on the host
                host = codec.host_routes["shared_decode"] - host
            runs[tag] = {"launches": launches, "shapes": shapes}
            rows = [r for r, _ in pairs]
            summary = run_robustness.summary_rows(rows)
            for row, recon in pairs:
                log(f"[harness] {tag} {json.dumps(row)}")
                if row["severity"] == 0 and (
                        recon is None or not np.array_equal(recon, phase3)):
                    raise AssertionError(f"[harness] {tag}: a severity-0 row "
                                         "is not phase 3's image")
            n_ok = sum(not r["decode_failed"] for r in rows)
            want = scaled_launches(per_decode, n_ok)
            if settings:
                want["rans_decode_shared"] = 2 * SLICES * (n_ok - host)
            log(f"[harness] {tag}: {len(rows)} rows in {sweep_s:.1f} s; "
                f"fail rates (target, mode, severity, n, fail_rate, psnr, "
                f"ms_ssim, lpips) {json.dumps(summary)}; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}")
            check_launches(f"harness {tag}", launches, want)
        torch.cuda.synchronize()  # a fault of the sweeps' launches raises here
        c_latent, guide_hint = model.apply_condition_decompress(
            tmp / "clean.rdeic")
        if not (torch.equal(c_latent, serve["latents"][0])
                and torch.equal(guide_hint, serve["latents"][1])):
            raise AssertionError("[harness] after the sweeps phase 3's stream "
                                 "decodes to other latents")

        # (e) a trace of one decode, and the allocator's statistics
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        with device_trace(tmp / "trace") as prof:
            out, ms = host_ms(lambda: model.decode_pipeline(
                c_latent, guide_hint, STEPS, **generator_noise(device, seed)()))
        launches, _ = read_counters()
        stats = memory_stats()[f"cuda:{device.index or 0}"]
        allocator = {"bytes_in_use": torch.cuda.memory_allocated(),
                     "peak_bytes_in_use": torch.cuda.max_memory_allocated(),
                     "bytes_limit": torch.cuda.get_device_properties(
                         device).total_memory}
        (trace,) = (tmp / "trace").glob("*.pt.trace.json")
        # the card's own events (kernels, copies, sets): the host ops that
        # launched them carry the same time again
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events.sort(key=lambda e: e.device_time_total, reverse=True)
        device_us = sum(e.device_time_total for e in events)
        top = [{"name": e.key[:72], "calls": e.count,
                "device_ms": round(e.device_time_total / 1e3, 3)}
               for e in events[:TRACE_TOP]]
        log(f"[harness] device_trace of one decode_pipeline ({ms:.1f} ms): "
            f"{trace.stat().st_size} bytes ({trace.name}); {len(events)} "
            f"kinds of device op, {device_us / 1e3:.3f} device ms; the "
            f"{TRACE_TOP} longest: {json.dumps(top)}")
        log(f"[harness] memory_stats: "
            f"{json.dumps({k: stats[k] for k in allocator})}; the allocator: "
            f"{json.dumps(allocator)}")
        if not device_us > 0:
            raise AssertionError("[harness] the trace holds no device time")
        if {k: stats[k] for k in allocator} != allocator:
            raise AssertionError("[harness] memory_stats differs from the "
                                 "allocator's counters")
        if not np.array_equal(to_uint8(out[0].cpu().numpy()), phase3):
            raise AssertionError("[harness] the traced decode is not phase "
                                 "3's image")
        check_launches("harness trace", launches, per_decode)
    return runs


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


def model_config(model) -> dict:
    if model.denoiser.remat_policy == "dots":
        return REFINE_DOTS_MODEL_CONFIG
    return REFINE_MODEL_CONFIG if model.is_refine else MODEL_CONFIG


def compute_dtype(model) -> torch.dtype:
    return model.denoiser.base.out_conv.compute_dtype


def cpu_copy(model) -> RDEIC:
    """The same model with its weights (in their dtypes) copied to the CPU,
    computing in the same dtype."""
    cpu = RDEIC(**model_config(model), device="meta").eval()  # weights follow
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        assign=True)
    cpu.set_compute_dtype(compute_dtype(model), cast_weights=False)
    return cpu


def make_bf16_train_model(device, seed: int) -> RDEIC:
    """The full-width model as the bf16 recipes build it, in train.py's
    order: on `meta`, computing in bf16 (`set_compute_dtype`, the weights
    keep their dtype), the frozen tensors cast to bf16 there (nothing is
    allocated), then `fast_init` on the card from `seed` (the JAX
    package's `fast_random_params` rule): the frozen weights are made in
    bf16, with no fp32 copy of the model."""
    model = RDEIC(**MODEL_CONFIG, device="meta").eval()
    model.set_compute_dtype(BF16, cast_weights=False)
    cast_frozen(model, BF16)
    return fast_random_init(model, device, seed=seed)


def make_bf16_refine_model(model, device, seed: int) -> RDEIC:
    """The bf16 refine-phase model of train_rdeic_refine_v5e.yaml
    (`remat_policy: "dots"`) over `model`'s own tensors (shared, not
    copied), with LPIPS(alex) made by `fast_init` from `seed` and stored
    in bf16 with the other frozen tensors."""
    with torch.device("meta"):
        lpips = LPIPS("alex")
    fast_random_init(lpips, device, seed=seed)
    refine = RDEIC(**REFINE_DOTS_MODEL_CONFIG, device="meta").eval()
    refine.set_compute_dtype(BF16, cast_weights=False)
    refine.load_state_dict(
        {**model.state_dict(),
         **{f"lpips.{k}": v for k, v in lpips.state_dict().items()}},
        assign=True)
    cast_frozen(refine, BF16)
    return refine


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative RMS of `got` against `want`, in fp32."""
    return ((got.float() - want.float()).square().mean()
            / want.float().square().mean()).sqrt().item()


def phase_reference(model, bf16, device, seed: int):
    """256x256 through the card (kernels) and the CPU (plain versions), from
    the same latents and noise: the fp32 model with DDPM, DDIM and
    classifier-free guidance (limit 2e-3 on the image), and the bf16 model
    (DDPM) against its own CPU copy (relative RMS within BF16_REF_TOL); a
    planted x1.05 fault must read outside each limit."""
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
    runs = (("ddpm", "ddpm", 1.0, model), ("ddim", "ddim", 1.0, model),
            ("cfg", "ddpm", CFG_SCALE, model), ("bf16", "ddpm", 1.0, bf16))
    cpus = {id(m): cpu_copy(m) for m in (model, bf16)}
    images, feats = {}, {}
    with torch.no_grad():
        for name, sampler, guidance, card in runs:
            for where, m, dev in (("cuda", card, device),
                                  ("cpu", cpus[id(card)], torch.device("cpu"))):
                t0 = time.perf_counter()
                out = m.decode_pipeline(
                    c_latent.to(dev), guide_hint.to(dev), STEPS,
                    sampler=sampler, guidance_scale=guidance,
                    relay_noise=relay.to(dev),
                    step_noise=[s.to(dev) for s in steps])
                images[name, where] = out.cpu()
                if name in ("ddpm", "bf16"):
                    _, feat = m.encode_first_stage(torch.from_numpy(img).to(dev))
                    feats[name, where] = feat.cpu()
                log(f"[reference] {name} on {where}: "
                    f"{time.perf_counter() - t0:.1f} s")
    del cpus
    def rel_max(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    ok = True
    for name, *_ in runs:
        got, want = images[name, "cuda"], images[name, "cpu"]
        if name == "bf16":
            err, fault = rel_rms(got, want), rel_rms(got * FAULT_SCALE, want)
            tol, what = BF16_REF_TOL, "relative RMS"
        else:
            err = (got - want).abs().max().item()
            fault = (got * FAULT_SCALE - want).abs().max().item()
            tol, what = 2e-3, "max|diff|"
        ok = ok and err <= tol < fault
        log(f"[reference] 256x256 {name}, card vs CPU: image {what} "
            f"{err:.3g} (limit {tol:.3g}; max|diff|/max "
            f"{rel_max(got, want):.3g}); a planted x{FAULT_SCALE} fault "
            f"reads {fault:.3g}")
    got, want = feats["ddpm", "cuda"], feats["ddpm", "cpu"]
    err = rel_max(got, want)
    ok = ok and err <= 1e-4
    log(f"[reference] ddpm VAE feature, card vs CPU: max|diff|/max {err:.3g} "
        "(limit 1e-4)")
    got, want = feats["bf16", "cuda"], feats["bf16", "cpu"]
    err, fault = rel_rms(got, want), rel_rms(got * FAULT_SCALE, want)
    ok = ok and err <= BF16_FEATURE_TOL < fault
    log(f"[reference] bf16 VAE feature, card vs CPU: relative RMS {err:.3g} "
        f"(limit {BF16_FEATURE_TOL:.3g}; max|diff|/max "
        f"{rel_max(got, want):.3g}); a planted x{FAULT_SCALE} fault reads "
        f"{fault:.3g}")
    for what, results in (("image", images), ("VAE feature", feats)):
        own, ref = results["bf16", "cuda"], results["ddpm", "cuda"]
        log(f"[reference] bf16 against fp32 on the card, {what}: relative "
            f"RMS {rel_rms(own, ref):.3g}, max|diff|/max {rel_max(own, ref):.3g}")
    if not ok:
        raise AssertionError("the card disagrees with the CPU reference, or "
                             "a planted fault reads within its limit")


def _grad_reads(got: dict, want: dict, floor: float, device=None) -> dict:
    """Per tensor: max |got - want| / max(max |want|, floor), taken on
    `device` when given (a difference, its magnitude and a max are exact:
    the same reads on any device)."""
    out = {}
    for k, w in want.items():
        g, w = (x if device is None else x.to(device) for x in (got[k], w))
        out[k] = (g - w).abs().max().item() / max(w.abs().max().item(), floor)
    return out


def train_ref_group(name: str) -> str:
    """The training reference's group of a trainable tensor."""
    if name.startswith("denoiser."):
        return "denoiser"
    return "synthesis" if name.startswith(SYNTHESIS_PREFIXES) else "rate"


class _MethodHook:
    """fn(name, output) around `obj.attr(...)`, as a forward hook around a
    method (its return value, if any, replaces the output); remove()
    restores the method."""

    def __init__(self, obj, attr: str, name: str, fn):
        self.obj, self.attr = obj, attr
        method = getattr(obj, attr)

        def call(*args, **kwargs):
            out = method(*args, **kwargs)
            new = fn(name, out)
            return out if new is None else new

        setattr(obj, attr, call)

    def remove(self):
        delattr(self.obj, self.attr)


def _hook_convs(model, fn) -> list:
    """fn(name, output) as a forward hook on every Conv of the compression
    model, on the codebook's logits (the distances its argmax and its
    contrastive top-k select from) and, in the refine phase, on every
    convolution of LPIPS (its return value, if any, replaces the output);
    the handles."""
    mods = [(f"compression.{n}", m) for n, m in model.compression.named_modules()
            if isinstance(m, Conv)]
    if model.is_refine:
        mods += [(f"lpips.{n}", m) for n, m in model.lpips.named_modules()
                 if isinstance(m, torch.nn.Conv2d)]
    return [mod.register_forward_hook(
                lambda _mod, _args, out, name=name: fn(name, out))
            for name, mod in mods] + [
        _MethodHook(model.compression.quantize, "logits",
                    "compression.quantize.logits", fn)]


def _group_rms(got: dict, want: dict, keys) -> float:
    """Relative RMS of the gradients `keys` taken together."""
    diff = sum((got[k] - want[k]).square().sum().item() for k in keys)
    return (diff / sum(want[k].square().sum().item() for k in keys)) ** 0.5


def phase_train_reference(model, device, seed: int) -> dict:
    """One B = 1, 256x256 training loss of the model's phase and its
    trainable gradients, on the card (kernels) and on the CPU (plain
    versions), from the same weights and noise; the CPU run takes the card's
    convolution outputs in the compression model (see TRAIN_REF_TOL), a
    second CPU run does not. At 256x256, L = 1024 reaches the flash kernels
    at d = 16 and 64 (and, in the refine phase's VAE decoder, d = 512). A
    model computing in bf16 (phases 9 and 11) is held to
    BF16_TRAIN_REF_TOL, its CPU run also taking the card's VAE encoder
    outputs, and then takes one `Trainer` step on the card with its frozen
    tensors in bf16: they stay bf16 and bit-equal, the trainable ones fp32."""
    bf16 = compute_dtype(model) == BF16
    tag = ("refine" if model.is_refine else "train") + (
        "-bf16-reference" if bf16 else "-reference")
    rng = np.random.default_rng(seed + 3)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32))
    noise = model.train_noise(img, torch.Generator().manual_seed(seed))
    cpu = cpu_copy(model)
    card_convs, conv_reads = {}, {}

    def record(name, out):  # LPIPS runs its backbone twice (image, target)
        card_convs.setdefault(name, []).append(
            tuple(o.detach().cpu() for o in out) if isinstance(out, tuple)
            else out.detach().cpu())

    def pin(name, out):
        calls = sum(k.split("#")[0] == name for k in conv_reads)
        if calls == len(card_convs[name]):
            raise AssertionError(f"{name} ran more often than on the card")
        want = card_convs[name][calls]
        if isinstance(out, tuple):  # the VAE encoder's (mean, logvar, feature)
            conv_reads[f"{name}#{calls}"] = max(
                rel_rms(o, w) for o, w in zip(out, want))
            return want
        if bf16 and name.startswith("lpips."):  # bf16 decoder output in
            conv_reads[f"{name}#{calls}"] = rel_rms(out.detach(), want)
        else:
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
        if hook and bf16:
            handles.append(_MethodHook(m.vae, "encode_hc", "vae.encode_hc", hook))
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
    faulty = {k: g * FAULT_SCALE for k, g in g_card.items()}
    conv_tol = {k: (BF16_TRAIN_REF_TOL["input"]
                    if bf16 and k.startswith(("lpips.", "vae.")) else
                    TRAIN_REF_TOL["conv"]) for k in conv_reads}
    worst_conv = max(conv_reads, key=lambda k: conv_reads[k] / conv_tol[k])
    tol = BF16_TRAIN_REF_TOL if bf16 else TRAIN_REF_TOL
    out = {"loss": abs(l_card - l_cpu) / abs(l_cpu),
           "fault_loss": abs(l_card * FAULT_SCALE - l_cpu) / abs(l_cpu),
           "loss_unpinned": abs(l_card - l_free) / abs(l_free),
           "conv": conv_reads[worst_conv]}
    ok = (out["loss"] <= tol["loss"] < out["fault_loss"]
          and all(v <= conv_tol[k] for k, v in conv_reads.items()))
    log(f"[{tag}] {len(conv_reads)} pinned outputs (compression model"
        f"{', LPIPS' if model.is_refine else ''}"
        f"{', VAE encoder' if bf16 else ''}), CPU from the card's inputs "
        f"vs the card: worst {out['conv']:.3g} ({worst_conv}; limit "
        f"{conv_tol[worst_conv]:.3g}); the codebook's logits "
        f"{max(v for k, v in conv_reads.items() if 'quantize' in k):.3g}"
        + (f"; the VAE encoder's outputs (relative RMS) "
           f"{conv_reads['vae.encode_hc#0']:.3g}" if bf16 else ""))
    if not bf16:  # per tensor, once for all three groups, on the card (on
        # the card's host these reads took ~30 s a pass over the gradients)
        reads = _grad_reads(g_card, g_cpu, floor, device)
        free_reads = _grad_reads(g_card, g_free, floor, device)
        fault_reads = _grad_reads(faulty, g_cpu, floor, device)
    for group in ("denoiser", "synthesis", "rate"):
        keys = [k for k in g_cpu if train_ref_group(k) == group]
        if bf16:  # relative RMS over the group
            out[group] = _group_rms(g_card, g_cpu, keys)
            out[f"unpinned_{group}"] = _group_rms(g_card, g_free, keys)
            out[f"fault_{group}"] = _group_rms(faulty, g_cpu, keys)
            limit, what = tol["grads"], "relative RMS"
            detail = ""
        else:
            worst = sorted(keys, key=reads.get, reverse=True)[:3]
            out[group] = reads[worst[0]]
            out[f"unpinned_{group}"] = max(free_reads[k] for k in keys)
            out[f"fault_{group}"] = max(fault_reads[k] for k in keys)
            limit, what = tol[group], "worst"
            detail = ": " + ", ".join(f"{k} {reads[k]:.3g}" for k in worst)
        ok = ok and out[group] <= limit < out[f"fault_{group}"]
        log(f"[{tag}] {group} ({len(keys)} tensors): card vs CPU {what} "
            f"{out[group]:.3g} (limit {limit:.3g}){detail}; a planted "
            f"x{FAULT_SCALE} fault reads {out[f'fault_{group}']:.3g}; against "
            f"the unpinned CPU run {out[f'unpinned_{group}']:.3g}")
    log(f"[{tag}] loss: card vs CPU {out['loss']:.3g} (limit "
        f"{tol['loss']:.3g}), planted fault {out['fault_loss']:.3g}, "
        f"unpinned {out['loss_unpinned']:.3g}")
    if not ok:
        raise AssertionError(f"[{tag}] training on the card disagrees with "
                             "the CPU, or a planted fault reads within its "
                             "limit")
    if bf16:
        bf16_step_keeps_dtypes(model, img.to(device), noise, tag)
    return out


def bf16_step_keeps_dtypes(model, img, noise, tag: str) -> None:
    """One `Trainer(frozen_dtype=bf16)` step on the card: every frozen
    float tensor (but the codebook usage) bf16 and bit-equal after it, every
    trainable one fp32, and each with a gradient moved."""
    dev = img.device
    moved = {k: [u.to(dev) for u in v] if isinstance(v, list) else v.to(dev)
             for k, v in noise.items()}
    pred = trainable_predicate(model.sd_locked)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, learning_rate=REFINE_CONFIG["learning_rate"],
                      frozen_dtype=BF16)
    logs = trainer.step(img, noise=moved)
    now = model.state_dict()
    frozen = [k for k, v in now.items() if is_frozen_float(k, v, pred)]
    bad = [k for k in frozen if now[k].dtype != BF16
           or not torch.equal(now[k], before[k])]
    bad += [k for k, p in trainer.params.items() if p.dtype != torch.float32]
    stepped = sum(not torch.equal(p, before[k]) for k, p in trainer.params.items())
    if bad or not torch.isfinite(logs["loss"]) or now["vq_embed_prob"].dtype != torch.float32:
        raise AssertionError(f"[{tag}] the bf16 step broke its dtypes: {bad[:5]}")
    log(f"[{tag}] one Trainer step: {len(frozen)} frozen tensors bf16 and "
        f"bit-equal, {len(trainer.params)} trainable fp32 ({stepped} moved), "
        "the codebook usage fp32")


def train_launches_per_step(model, n_flash: int = FLASH_PER_DENOISER_CALL_512
                            ) -> dict:
    """Kernel launches of one training micro-step at 512x512 (`n_flash`
    self-attentions over >= 1024 tokens a denoiser call; another size
    passes its own), from the
    model's structure: the denoiser runs once (independent phase) or once
    per sampler step (refine); each of its flash self-attentions runs the
    forward with lse (twice when the blocks are recomputed in the backward
    or the sampler step is), dq and dkv once; each GroupNorm32 call is one
    forward launch (again when its block or step is recomputed) and one
    backward launch. The VAE encoder's mid-block attention runs the plain
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
            "group_norm_silu_bwd": calls * n_gn}


def phase_training(model, device, seed: int) -> dict:
    """The full-width training path of the model's phase: one warm-up
    micro-step, then TRAIN_STEPS (independent) or REFINE_STEPS (refine)
    counted and timed ones. A model computing in bf16 trains with its
    frozen tensors in bf16 (`frozen_dtype`), and every flash call of its
    path must run in bf16."""
    tag, cfg, steps = (("refine", REFINE_CONFIG, REFINE_STEPS) if model.is_refine
                       else ("train", TRAIN_CONFIG, TRAIN_STEPS))
    bf16 = compute_dtype(model) == BF16
    tag += "_bf16" if bf16 else ""
    rng = np.random.default_rng(seed + 2)
    hw = cfg["out_size"]
    imgs = [torch.from_numpy(rng.uniform(
        -1, 1, (cfg["batch_size"], hw, hw, 3)).astype(np.float32)).to(device)
        for _ in range(1 + steps)]
    trainer = Trainer(model, learning_rate=cfg["learning_rate"],
                      accumulate_grad_batches=cfg["accumulate_grad_batches"],
                      frozen_dtype=BF16 if bf16 else None)
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
    want = {**dict.fromkeys(KERNEL_FNS, 0),
            **{k: v * steps for k, v in per_step.items()}}
    ms = float(np.mean(step_ms))
    log(f"[{tag}] warm-up micro-step {warm_ms:.1f} ms; micro-steps (B = "
        f"{cfg['batch_size']}, {hw}x{hw}) {json.dumps(step_ms)} ms, "
        f"mean {ms:.1f} ms, {cfg['batch_size'] * 1e3 / ms:.3f} images/s; "
        f"peak memory {peak / 2**30:.2f} GiB; losses {json.dumps(losses)}")
    log(f"[{tag}] launches per micro-step: "
        f"{json.dumps({k: v / steps for k, v in launches.items()})}; from "
        f"the structure {json.dumps(per_step)}")
    by_dtype = {name: {dt: sum(c for k, c in shapes[name].items() if k[-1] == dt)
                       / steps for dt in ("float32", "bfloat16")}
                for name in shapes}
    log(f"[{tag}] launches per micro-step by dtype: {json.dumps(by_dtype)}")
    for name in ("group_norm_silu_fwd", "group_norm_silu_bwd"):
        pairs = {}
        for k, c in shapes[name].items():  # (..., scale and bias dtype, dtype)
            pair = f"x {k[-1]}, params {k[-2]}"
            pairs[pair] = pairs.get(pair, 0) + c / steps
        log(f"[{tag}] {name} calls per micro-step by (x, scale and bias) "
            f"dtype: {json.dumps(pairs)}")
    by_kernel = {}
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        for k, c in shapes[name].items():  # (B, L, H, D, dtype)
            kernel = flash_bwd_kernel(name.rsplit("_", 1)[-1], k[3],
                                      getattr(torch, k[-1]))
            by_kernel[kernel] = by_kernel.get(kernel, 0) + c / steps
    log(f"[{tag}] flash backward launches per micro-step by CUDA kernel: "
        f"{json.dumps(by_kernel)}")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    if bf16 and any(by_dtype[k]["float32"] for k in shapes if k.startswith("flash")):
        raise AssertionError(f"[{tag}] a flash call ran in fp32: {by_dtype}")
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
    if bf16 and any(now[k].dtype != BF16 for k in frozen):
        raise AssertionError(f"[{tag}] a frozen tensor left bf16")
    return {"ms": ms, "step_ms": step_ms, "warm_ms": warm_ms,
            "images_per_s": cfg["batch_size"] * 1e3 / ms, "steps": steps,
            "peak_bytes": peak, "launches": launches, "shapes": shapes,
            "losses": losses, "by_dtype": by_dtype}


class _AttentionShapes:
    """Forward pre-hooks on every self-attention of a model (each UNet and
    control transformer's `attn1`, and the VAE's mid-block `AttnBlock`):
    the (L, heads, head dim) of each call while installed."""

    def __init__(self, model):
        self.calls = []
        self.handles = []
        for m in model.modules():
            if isinstance(m, CrossAttention):
                self.handles.append(m.register_forward_pre_hook(self._cross))
            elif isinstance(m, AttnBlock):
                self.handles.append(m.register_forward_pre_hook(self._vae))

    def _cross(self, module, args):
        if len(args) == 1:  # attn1: no context, self-attention
            self.calls.append((args[0].shape[1], module.heads, module.dim_head))

    def _vae(self, module, args):
        b, c, h, w = args[0].shape
        self.calls.append((h * w, 1, c))

    def remove(self):
        for h in self.handles:
            h.remove()

    def flash(self) -> list:
        """The calls `ops/attention.py` sends to the flash kernel."""
        return [c for c in self.calls if c[0] >= FLASH_MIN_TOKENS]


def val_images(seed: int, n: int, hw: int, batch: int, device) -> list:
    """`n` in-memory batches of [-1, 1] images, as the loader gives them."""
    rng = np.random.default_rng(seed)
    return [{"jpg": torch.from_numpy(rng.uniform(
        -1, 1, (batch, hw, hw, 3)).astype(np.float32)).to(device)}
        for _ in range(n)]


def phase_validate(model, device, seed: int, tag: str, want_bf16: bool) -> dict:
    """Phase 14a / 14b: `run_validation` over VAL_BATCHES batches of one
    512x512 image (after one warm-up batch), the root train.py's metrics
    and steps; ms a batch, peak memory, launches a batch against the
    model's self-attention shapes (every one of >= FLASH_MIN_TOKENS tokens
    launches flash: the UNet's 64x64 and 32x32 levels, one VAE encoder and
    two decoder mid-blocks at d = 512) and its GroupNorm32 calls, every
    average finite; with `want_bf16`, every flash call bf16 and every
    GroupNorm call on a bf16 branch (x, or scale and bias)."""
    hw = VAL_CONFIG["out_size"]
    batches = val_images(seed + 3, 1 + VAL_BATCHES, hw,
                         VAL_CONFIG["batch_size"], device)
    suite = MetricSuite()
    gen = torch.Generator(device=device).manual_seed(seed)
    run_validation(model, batches[:1], sample_steps=VAL_STEPS,
                   metric_names=VAL_METRICS, generator=gen, suite=suite)
    reset_counters()
    hooks = _AttentionShapes(model)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        vm, ms = host_ms(lambda: run_validation(
            model, batches[1:], sample_steps=VAL_STEPS,
            metric_names=VAL_METRICS, generator=gen, suite=suite))
    finally:
        hooks.remove()
    peak = torch.cuda.max_memory_allocated()
    launches, shapes = read_counters()
    steps = model.fixed_step if model.is_refine else VAL_STEPS
    n_gn = sum(isinstance(m, GroupNorm32) for m in model.denoiser.modules())
    flash = hooks.flash()
    want = dict.fromkeys(KERNEL_FNS, 0)
    want.update({"flash_attn_fwd": len(flash),
                 "group_norm_silu_fwd": n_gn * steps * VAL_BATCHES})
    per = {k: v / VAL_BATCHES for k, v in launches.items() if v}
    log(f"[validate] ({tag}) {VAL_BATCHES} batches of 1x{hw}x{hw}, "
        f"{steps} sampler steps: {ms / VAL_BATCHES:.1f} ms a batch (host "
        f"clock, synchronised); peak memory {peak / 2**30:.3f} GiB "
        f"({(peak - resident) / 2**30:.3f} above the "
        f"{resident / 2**30:.3f} GiB resident); launches a batch "
        f"{json.dumps(per)}; {json.dumps(vm)}")
    by_len = {}
    for seq, h, d in flash:
        by_len[f"L{seq} h{h} d{d}"] = by_len.get(f"L{seq} h{h} d{d}", 0) + 1
    log(f"[validate] ({tag}) flash self-attentions a batch, from the "
        f"model's shapes: {json.dumps({k: v / VAL_BATCHES for k, v in by_len.items()})}")
    if len(flash) != (FLASH_PER_DENOISER_CALL_512 * steps + 3) * VAL_BATCHES:
        raise AssertionError(f"[validate] ({tag}) {len(flash)} self-"
                             "attentions over the flash threshold")
    if launches != want:
        raise AssertionError(f"[validate] ({tag}) launches {launches}, "
                             f"expected {want}")
    vae = sum(d == 512 for _, _, d in flash)
    if vae != 3 * VAL_BATCHES or not any(seq == FLASH_MIN_TOKENS
                                         for seq, _, _ in flash):
        raise AssertionError(f"[validate] ({tag}) flash self-attentions "
                             f"{by_len}: expected 3 a batch at d = 512 and "
                             f"the 32x32 level's L = {FLASH_MIN_TOKENS}")
    if set(vm) != {f"avg_{k}" for k in ("bpp", *VAL_METRICS)} | {"usage"} \
            or not all(math.isfinite(v) for v in vm.values()):
        raise AssertionError(f"[validate] ({tag}) averages {vm}")
    if want_bf16:
        flash_dtypes = {k[-1] for k in shapes["flash_attn_fwd"]}
        gn_fp32 = [k for k in shapes["group_norm_silu_fwd"]
                   if k[-1] == k[-2] == "float32"]
        if flash_dtypes != {"bfloat16"} or gn_fp32:
            raise AssertionError(f"[validate] ({tag}) flash ran in "
                                 f"{flash_dtypes}; GroupNorm all fp32 at "
                                 f"{gn_fp32}")
    return {"ms": ms / VAL_BATCHES, "peak_bytes": peak, "launches": launches,
            "shapes": shapes, "steps": VAL_BATCHES, "averages": vm}


def read_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit RGB PNG whose rows carry filter 0 (what
    `utils/image.encode_png` writes), read through zlib alone; each chunk's
    CRC checked."""
    if not data.startswith(PNG_SIGNATURE):
        raise AssertionError("not a PNG file")
    pos, chunks = len(PNG_SIGNATURE), {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        tag, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise AssertionError(f"PNG chunk {tag} fails its CRC")
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2) or b"IEND" not in chunks:
        raise AssertionError(f"PNG depth {depth}, color type {color}")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError("a PNG row carries a filter")
    return rows[:, 1:].reshape(h, w, 3)


def phase_image_logger(model, device, seed: int) -> None:
    """Phase 14c: `ImageLogger.maybe_log` on a batch of VAL_LOG_BATCH
    512x512 images into a temporary directory; its three PNGs, read back
    through zlib, equal `to_uint8` of the panels it drew, byte for byte,
    and its bpp.txt the bpp."""
    hw = VAL_CONFIG["out_size"]
    img = val_images(seed + 4, 1, hw, VAL_LOG_BATCH, device)[0]["jpg"]
    with tempfile.TemporaryDirectory() as tmp:
        logger = ImageLogger(tmp, every_n_steps=1)
        gen = torch.Generator(device=device).manual_seed(seed)
        (out_dir, panels, bpp), ms = host_ms(
            lambda: logger.maybe_log(model, img, 1, generator=gen))
        for name, panel in panels.items():
            got = read_png((out_dir / f"{name}.png").read_bytes())
            want = make_grid(panel)
            if (got.shape != (hw, hw * VAL_LOG_BATCH, 3)
                    or got.tobytes() != want.tobytes()):
                raise AssertionError(f"[validate] (c) {name}.png differs "
                                     "from its panel")
        if (out_dir / "bpp.txt").read_text() != f"{bpp:.6f}\n":
            raise AssertionError("[validate] (c) bpp.txt")
        files = sorted(p.name for p in out_dir.iterdir())
    log(f"[validate] (c) image logger, B = {VAL_LOG_BATCH} at {hw}x{hw}: "
        f"{ms:.1f} ms; {files}; the three PNGs read back through zlib equal "
        f"the panels byte for byte; bpp {bpp:.6f}")


def phase_validate_reference(model, device, seed: int) -> None:
    """Phase 14d: one 256x256 image through `run_validation` on the card
    and on a CPU copy of the model, with the same sampler noise, VAL_REF_STEPS
    steps and the same LPIPS weights; each average within VAL_REF_TOL of
    the CPU's, and a x1.05 fault of the card's outside it. It runs before
    the training phases, on the weights made from --seed, so every run of a
    seed compares the same model. Logged beside it: the margins that decide
    the compression model's discrete choices (the codebook's top-2 logit gap,
    the distance of y - mu from a rounding edge), the card-vs-CPU difference
    of their inputs, and how many choices differ."""
    batch = val_images(seed + 5, 1, VAL_REF_HW, 1, "cpu")
    rng = np.random.default_rng(seed + 6)
    side = VAL_REF_HW // model.latent_factor
    latent = (1, side, side, model.latent_channels)
    noise = [torch.from_numpy(rng.standard_normal(latent).astype(np.float32))
             for _ in range(1 + VAL_REF_STEPS)]
    with torch.device("meta"):
        lpips = LPIPS("alex")
    lpips_sd = fast_random_init(lpips, "cpu", seed=seed).state_dict()
    out, seen = {}, {}
    real_round = compression_module.ste_round
    for where, m in (("card", model), ("cpu", cpu_copy(model))):
        dev = next(m.parameters()).device
        seen[where] = {"logits": [], "round": []}

        def record(name, x, rec=seen[where]):
            rec[name].append(x.detach().float().cpu())

        def rounding(x, rec=record):
            rec("round", x)
            return real_round(x)

        hook = _MethodHook(m.compression.quantize, "logits", "logits", record)
        compression_module.ste_round = rounding
        try:
            out[where] = run_validation(
                m, [{"jpg": batch[0]["jpg"].to(dev)}],
                sample_steps=VAL_REF_STEPS, metric_names=VAL_METRICS,
                noise=[{"relay_noise": noise[0].to(dev),
                        "step_noise": [x.to(dev) for x in noise[1:]]}],
                suite=MetricSuite({k: v.to(dev) for k, v in lpips_sd.items()}))
        finally:
            compression_module.ste_round = real_round
            hook.remove()
    logits = [torch.cat([x.flatten(0, -2) for x in seen[w]["logits"]])
              for w in ("card", "cpu")]
    top2 = logits[0].topk(2, dim=1).values
    rounds = [torch.cat([x.flatten() for x in seen[w]["round"]])
              for w in ("card", "cpu")]
    margins = {
        "codebook_top2_gap_min": (top2[:, 0] - top2[:, 1]).min().item(),
        "codebook_logits_card_vs_cpu": (logits[0] - logits[1]).abs().max().item(),
        "codebook_indices_differ": int((logits[0].argmax(1)
                                        != logits[1].argmax(1)).sum()),
        "codebook_rows": logits[0].shape[0],
        "rounding_edge_distance_min": (
            0.5 - (rounds[0] - torch.round(rounds[0])).abs()).min().item(),
        "rounding_inputs_card_vs_cpu": (rounds[0] - rounds[1]).abs().max().item(),
        "rounded_symbols_differ": int((torch.round(rounds[0])
                                       != torch.round(rounds[1])).sum()),
        "rounded_symbols": rounds[0].numel()}
    log(f"[validate] (d) the compression model's discrete choices, card vs "
        f"CPU: {json.dumps(margins)}")
    reads = {}
    for key, tol in VAL_REF_TOL.items():
        card, cpu = out["card"][key], out["cpu"][key]
        err = abs(card - cpu) / abs(cpu)
        fault = abs(card * FAULT_SCALE - cpu) / abs(cpu)
        reads[key] = {"card": card, "cpu": cpu, "err": err, "limit": tol,
                      "fault": fault}
        if not err <= tol < fault:
            raise AssertionError(f"[validate] (d) {key}: {reads[key]}")
    log(f"[validate] (d) card vs CPU, one {VAL_REF_HW}x{VAL_REF_HW} image, "
        f"{VAL_REF_STEPS} steps, the same noise: {json.dumps(reads)}")


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _bound_ms(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    """The least ms for `nbytes` of HBM traffic and `flops` at `rate`
    flop/s, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def softmax_bound_ms(b: int, h: int, seq: int) -> float:
    """The least ms for the B H L^2 exponentials of one flash kernel (the
    forward's P, or the P that dq and dkv each recompute) on the card's
    MUFU units. `bound_ms` counts the products only."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (b * h * seq * seq / (MUFU_EX2_PER_CLOCK * sms * BOOST_CLOCK_HZ)
            * 1e3)


def flash_fwd_kernel(d: int, dtype) -> str:
    """The CUDA kernels behind a flash forward call (csrc/flash_attn_fwd.cu;
    the fp32 d = 16 call launches the split kernel, then the forward)."""
    if dtype == torch.bfloat16 and d in BF16_FWD_HEAD_DIMS:
        return f"flash_fwd_d{d}_bf16"
    if d == 16:
        return "flash_fwd_d16_split + flash_fwd_d16"
    if d in HOPPER_FWD_HEAD_DIMS:
        return f"flash_fwd_d{d}"
    return f"flash_fwd_d{d}<{'fp32' if dtype == torch.float32 else 'bf16'}>"


def flash_bwd_kernel(name: str, d: int, dtype) -> str:
    """The CUDA kernel behind a dq or dkv call (name "dq" or "dkv";
    csrc/flash_attn_bwd.cu)."""
    if dtype == torch.bfloat16 and d in BF16_BWD_HEAD_DIMS:
        return f"flash_{name}_d{d}_bf16"
    if d in HOPPER_BWD_FP32_HEAD_DIMS:  # no template
        return f"flash_{name}_d{d}"
    return f"flash_{name}_d{d}<{'fp32' if dtype == torch.float32 else 'bf16'}>"


def flash_rate(d: int, dtype, backward: bool = False) -> tuple[float, str]:
    """(flop/s, its name) that bounds a flash kernel (forward, or dq and
    dkv when `backward`) at head dim d. fp32: the TF32 tensor cores over the
    three passes of 3xTF32 where the kernel runs them (TC_HEAD_DIMS), else
    fp32 FMA. bf16: the card's bf16 peak, whichever route the kernel takes
    (bf16 mma at BF16_FWD_HEAD_DIMS and, backward, BF16_BWD_HEAD_DIMS:
    every head dim of the paths)."""
    tc = TC_HEAD_DIMS["backward" if backward else "forward"]
    if dtype == torch.float32 and d in tc:
        return TF32_FLOPS / 3, f"TF32 tensor cores {TF32_FLOPS / 1e12:g} / 3 passes"
    return PEAK_FLOPS[dtype], ("fp32 FMA 67" if dtype == torch.float32
                               else "bf16 989")


def _flash_bound_ms(nbytes: float, flops: float, d: int, dtype,
                    backward: bool = False) -> tuple[float, str, str]:
    """bound ms, what bounds it, and the rate used (flash_rate)."""
    rate, name = flash_rate(d, dtype, backward)
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
    return {**r, "kernel": flash_fwd_kernel(d, dtype), "bound_ms": bound,
            "bound_by": by, "bound_rate": rate,
            "softmax_bound_ms": softmax_bound_ms(b, h, seq),
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
    """The kernel against the plain version on the same values with fp32
    and with bf16 scale and bias (the two parameter branches): fp32 x at
    GN_TOL absolute; bf16 x against the plain version in fp32, unrounded,
    at REL_TOL of max (as the training rows). The times take the key's
    scale and bias dtype, as the path that ran it."""
    b, c, h, w, groups, eps, silu, param_dtype, dtype = key
    dtype, param_dtype = getattr(torch, dtype), getattr(torch, param_dtype)
    x = _randn((b, c, h, w), dtype, device, 0) * 3 + 1
    wt, bs = (_randn((c,), torch.float32, device, s) for s in (1, 2))
    reads = []
    for e in (1e-5, 1e-6):  # both eps and both SiLU settings
        for s in (False, True):
            for wp, bp in ((wt, bs), (wt.to(BF16), bs.to(BF16))):
                name = f"group_norm {key} eps={e} silu={s} params {wp.dtype}"
                got = group_norm(x, wp, bp, groups, e, s)
                want = group_norm_plain(x.float(), wp.float(), bp.float(),
                                        groups, e, s)
                reads.append(
                    compare(name, got, want, GN_TOL)
                    if dtype == torch.float32 else
                    compare_rel(name, [(got, want, REL_TOL[dtype])]))
    wt, bs = wt.to(param_dtype), bs.to(param_dtype)
    bound, by = _bound_ms(2 * x.numel() * x.element_size()
                          + 2 * c * wt.element_size(),
                          10.0 * x.numel(), PEAK_FLOPS[dtype])

    wl, bl = wt.to(dtype), bs.to(dtype)  # F.group_norm takes x's dtype

    def library():
        y = F.group_norm(x, groups, wl, bl, eps)
        return F.silu(y) if silu else y

    return {"max_abs_err": max(r["max_abs_err"] for r in reads),
            **({"max_rel_err": max(r["max_rel_err"] for r in reads)}
               if "max_rel_err" in reads[0] else {}),
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
    # the output also within the forward's own limit (flash_tol)
    r_lse["flash_tol"] = compare(f"flash lse output {shape} {dtype}", o,
                                 want_o, flash_tol(dtype, want_o))
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    again = (*flash_attention_dq(q, k, v, o, lse, do),
             *flash_attention_dkv(q, k, v, do, lse, di))
    if not all(torch.equal(a, b) for a, b in zip((dq, di, dk, dv), again)):
        raise AssertionError(f"flash backward {shape} {dtype}: two launches "
                             "gave different bits")
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
                                       dtype, backward=True)
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
        bound, by, rate = _flash_bound_ms(nbytes, flops, d, dtype,
                                          name != "flash_attn_fwd_lse")
        kernel = (flash_fwd_kernel(d, dtype) if name == "flash_attn_fwd_lse"
                  else flash_bwd_kernel(name.rsplit("_", 1)[-1], d, dtype))
        dev, host = device_ms(fn, reps)
        rows_out[name] = {**r, "bound_ms": bound, "bound_by": by,
                          "bound_rate": rate,
                          "softmax_bound_ms": softmax_bound_ms(b, h, seq),
                          "kernel": kernel,
                          "ms": cuda_ms(fn, reps), "device_ms": dev,
                          "host_us": host * 1e3,
                          "plain_ms": plain, "library_ms": library,
                          "library_device_ms": library_dev}
        if name != "flash_attn_fwd_lse":
            rows_out[name]["backward_bound_ms"] = pair_bound
        if name != "flash_attn_fwd_lse" and dtype == torch.bfloat16:
            # the bf16 kernels take P and dS as two bf16 terms (the
            # precision rule): dq issues S, dP and dS K twice (8 B H L^2 d
            # flops), dkv S, dP, P^T dO twice and dS^T Q twice (12)
            terms = 8 * ops if name == "flash_attn_bwd_dq" else 12 * ops
            rows_out[name]["two_term_bound_ms"] = _flash_bound_ms(
                nbytes, terms, d, dtype, backward=True)[0]
    return rows_out


def check_groupnorm_bwd(device, key, reps) -> dict:
    """The backward kernel against the plain backward on one shape, with
    SiLU off and on and with fp32 and with bf16 scale and bias (the two
    parameter branches: bf16 ones give bf16 dscale and dbias), from the
    forward kernel's mean and 1/std; a second run must give the same bits
    (the cluster and the batch sums add in a fixed order). The times take
    the key's scale and bias dtype, as the path that ran it."""
    b, c, h, w, groups, _, silu, param_dtype, dtype = key
    dtype, param_dtype = getattr(torch, dtype), getattr(torch, param_dtype)
    x = _randn((b, c, h, w), dtype, device, 0) * 3 + 1
    dy = _randn((b, c, h, w), dtype, device, 3)
    wt, bs = (_randn((c,), torch.float32, device, s) for s in (1, 2))
    reads = []
    for s in (False, True):
        for wp, bp in ((wt, bs), (wt.to(BF16), bs.to(BF16))):
            name = f"group_norm_bwd {key} silu={s} params {wp.dtype}"
            _, mean, inv = group_norm_fwd(x, wp, bp, groups, 1e-5, s)
            got = group_norm_bwd(x, wp, bp, mean, inv, dy, groups, s)
            again = group_norm_bwd(x, wp, bp, mean, inv, dy, groups, s)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two runs gave different bits")
            # unrounded, as for flash
            want = group_norm_bwd_plain(x.float(), wp.float(), bp.float(),
                                        mean, inv, dy.float(), groups, s)
            reads.append(compare_rel(name, [
                (got[0], want[0], REL_TOL[dtype]),
                (got[1], want[1], REL_TOL[wp.dtype]),
                (got[2], want[2], REL_TOL[wp.dtype])]))
    wt, bs = wt.to(param_dtype), bs.to(param_dtype)
    _, mean, inv = group_norm_fwd(x, wt, bs, groups, 1e-5, silu)
    # F.group_norm takes weight and bias in the input's dtype
    xl, wl, bl = (t.detach().to(dtype).requires_grad_() for t in (x, wt, bs))
    y = F.group_norm(xl, groups, wl, bl, 1e-5)
    y = F.silu(y) if silu else y
    bound, by = _bound_ms(3 * x.numel() * x.element_size()
                          + 4 * c * wt.element_size(),
                          15.0 * x.numel(), PEAK_FLOPS[dtype])
    return {"max_abs_err": max(r["max_abs_err"] for r in reads),
            "max_rel_err": max(r["max_rel_err"] for r in reads),
            "tol": [REL_TOL[dtype], REL_TOL[param_dtype], REL_TOL[param_dtype]],
            "fault_err": min(r["fault_err"] for r in reads),
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
            **({"softmax_bound_ms": total("softmax_bound_ms")}
               if "softmax_bound_ms" in rows[0] else {}),
            **({"bound_rates": sorted({r["bound_rate"] for r in rows})}
               if "bound_rate" in rows[0] else {}),
            **({"cuda_kernels": sorted({r["kernel"] for r in rows})}
               if "kernel" in rows[0] else {}),
            "shapes": rows}


def bwd_error_vs_float64(device, shape) -> list:
    """dq, dk and dv of the fp32 kernels against the plain backward in
    float64 on the same inputs (and the kernel forward's o and lse): max
    |error| over max of each. The fp32 plain version sums in fp32 too, so
    only float64 shows how a kernel's own error moves with L."""
    q, k, v, do = (_randn(shape, torch.float32, device, s) for s in range(4))
    o, lse = flash_attention_lse(q, k, v)
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    got = (dq, *flash_attention_dkv(q, k, v, do, lse, di))
    want = flash_attention_bwd_plain(*(x.double() for x in (q, k, v, o)),
                                     lse.double(), do.double())
    return [((g.double() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]


def fwd_error_vs_float64(device, shape) -> float:
    """max |o - o64| of the fp32 forward kernel against the plain version in
    float64 on the same inputs: only float64 shows how the kernel's own
    error moves with L."""
    q, k, v = (_randn(shape, torch.float32, device, s) for s in range(3))
    o = flash_attention(q, k, v)
    want = flash_attention_plain(*(x.double() for x in (q, k, v)))
    return (o.double() - want).abs().max().item()


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

    serve_paths = [p for p in runs if p.startswith("serve")]
    # per image for the serving paths, per run (PARTITION_SIZES, two
    # chunks) for batched serving
    fwd_paths = {p: "image" if p.startswith("serve") else
                 f"run of {len(PARTITION_SIZES)} images"
                 if p.startswith("partition") else
                 f"{TILED_HW[1]}x{TILED_HW[0]} image"
                 for p in runs if p.startswith(("serve", "partition", "tiled"))}
    flash_keys = keys("flash_attn_fwd")
    flash_rows = []
    # each shape once in each dtype; a row for fp32 (every serving shape)
    # and for each dtype a path ran it in (bf16: the bf16 serving run)
    for shape in dict.fromkeys([*FLASH_SHAPES, *(k[:4] for k in flash_keys)]):
        for dtype in (torch.float32, torch.bfloat16):
            key = (*shape, str(dtype).removeprefix("torch."))
            r = check_flash(device, shape, dtype, reps=5)
            log(f"[kernels] flash {shape} {dtype}: {json.dumps(r)}")
            if dtype == torch.float32 or key in flash_keys:
                flash_rows.append({"shape": list(key),
                                   "calls": calls("flash_attn_fwd", key), **r})
    gn_rows = []
    serve_gn = keys("group_norm_silu_fwd", serve_paths)
    for key in keys("group_norm_silu_fwd"):
        reps = 20 if key in serve_gn else 5
        r = check_groupnorm(device, key, reps=reps)
        log(f"[kernels] group_norm {key}: {json.dumps(r)}")
        gn_rows.append({"shape": list(key),
                        "calls": calls("group_norm_silu_fwd", key), **r})
    for key in GN_STREAM_KEYS:
        r = check_groupnorm(device, key, reps=3)
        log(f"[kernels] group_norm {key} (on no path, streamed): {json.dumps(r)}")
        if key[-1] == "float32":
            gn_rows.append({"shape": list(key), "calls": {}, **r})

    train_paths = tuple(p for p in TRAIN_PATHS if p in runs)
    train_rows = {k: [] for k in ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv", "group_norm_silu_bwd")}
    for p in train_paths:
        if (set(runs[p]["shapes"]["flash_attn_bwd_dq"])
                != set(runs[p]["shapes"]["flash_attn_fwd_lse"])):
            raise AssertionError(f"{p}: the backward ran at other shapes than "
                                 "the forward")
    # each shape once in each dtype; a row for each dtype a path ran it in
    lse_keys = keys("flash_attn_fwd_lse", train_paths)
    for shape in dict.fromkeys(k[:4] for k in lse_keys):
        for dtype in (torch.float32, torch.bfloat16):
            key = (*shape, str(dtype).removeprefix("torch."))
            rows = check_flash_train(device, shape, dtype, reps=3)
            log(f"[kernels] flash training {shape} {dtype}: {json.dumps(rows)}")
            if key in lse_keys:
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
    # each shape in both dtypes of x, each check reading both scale and bias
    # dtypes; a row, timed with its own scale and bias dtype, for each
    # (x, scale and bias) dtype pair a path ran
    bwd_keys = keys("group_norm_silu_bwd", train_paths)
    for shape in dict.fromkeys(k[:7] for k in bwd_keys):
        for dtype in ("float32", "bfloat16"):
            ran = [k for k in bwd_keys if k[:7] == shape and k[-1] == dtype]
            for key in ran or [(*shape, "float32", dtype)]:
                r = check_groupnorm_bwd(device, key, reps=10)
                log(f"[kernels] group_norm_bwd {key}: {json.dumps(r)}")
                if key in bwd_keys:
                    train_rows["group_norm_silu_bwd"].append(
                        {"shape": list(key),
                         "calls": calls("group_norm_silu_bwd", key), **r})
    for key in GN_STREAM_KEYS:
        r = check_groupnorm_bwd(device, key, reps=3)
        log(f"[kernels] group_norm_bwd {key} (on no path, streamed): "
            f"{json.dumps(r)}")
        if key[-1] == "float32":
            train_rows["group_norm_silu_bwd"].append(
                {"shape": list(key), "calls": {}, **r})

    flash_src = "rdeic_torch/csrc/flash_attn_fwd.cu"
    bwd_src = "rdeic_torch/csrc/flash_attn_bwd.cu"
    gn_src = "rdeic_torch/csrc/group_norm_fwd.cu"
    gn_bwd_src = "rdeic_torch/csrc/group_norm_bwd.cu"
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
        summarize("group_norm_silu_bwd", "cuda", gn_bwd_src,
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
    for path in ("train_bf16", "refine_bf16"):
        if path not in runs:
            continue
        per = {name: sum(r["ms"] * r["calls"].get(path, 0) for r in rows)
               for name, rows in train_rows.items()}
        bwd = sum(per[k] for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                                   "group_norm_silu_bwd"))
        log(f"[kernels] backward kernels per {path} micro-step: flash dq "
            f"{per['flash_attn_bwd_dq']:.3f} + dkv "
            f"{per['flash_attn_bwd_dkv']:.3f} + GroupNorm backward "
            f"{per['group_norm_silu_bwd']:.3f} = {bwd:.3f} ms, "
            f"{100 * bwd / runs[path]['ms']:.2f}% of the "
            f"{runs[path]['ms']:.1f} ms micro-step; lse forward "
            f"{per['flash_attn_fwd_lse']:.3f} ms")
    for dq, dkv in zip(train_rows["flash_attn_bwd_dq"],
                       train_rows["flash_attn_bwd_dkv"]):
        log(f"[kernels] flash backward per call {dq['shape']}: dq "
            f"({dq['kernel']}) {dq['ms']:.4f} (device {dq['device_ms']:.4f}) "
            f"+ dkv ({dkv['kernel']}) {dkv['ms']:.4f} (device "
            f"{dkv['device_ms']:.4f}) = {dq['ms'] + dkv['ms']:.4f} (device "
            f"{dq['device_ms'] + dkv['device_ms']:.4f}) ms; own bounds "
            f"{dq['bound_ms']:.4f} + {dkv['bound_ms']:.4f} ms, the pair's "
            f"{dq['backward_bound_ms']:.4f} ms at {dq['bound_rate']}"
            + (f" (at the rule's two terms of P and dS: "
               f"{dq['two_term_bound_ms']:.4f} + {dkv['two_term_bound_ms']:.4f}"
               f" = {dq['two_term_bound_ms'] + dkv['two_term_bound_ms']:.4f}"
               " ms)" if "two_term_bound_ms" in dq else "")
            + ", its "
            f"exponentials' floor "
            f"{dq['softmax_bound_ms'] + dkv['softmax_bound_ms']:.4f} ms; SDPA "
            f"backward {dq['library_ms']:.4f} (device "
            f"{dq['library_device_ms']:.4f}) ms")
    for d in (16, 64, 512):
        reads = {seq: bwd_error_vs_float64(device, (1, seq, 1 if d == 512
                                                    else 2, d))
                 for seq in (1024, 8192)}
        log(f"[kernels] flash backward fp32 error against float64 at d = {d} "
            f"({flash_bwd_kernel('dq', d, torch.float32)}, "
            f"{flash_bwd_kernel('dkv', d, torch.float32)}), "
            "max |g - g64| / max |g64| of dq, dk, dv: "
            + "; ".join(f"L = {seq}: " + ", ".join(f"{x:.3g}" for x in r)
                        for seq, r in reads.items()))
        tol = BWD512_F64_TOL if d == 512 else BWD64_F64_TOL
        if d in HOPPER_BWD_FP32_HEAD_DIMS and not (
                max(reads[8192]) < tol
                and max(reads[8192]) <= 2 * max(reads[1024])):
            raise AssertionError(
                f"the fp32 d = {d} backward's error grows with L or passes "
                f"{tol} of max at L = 8192: {reads}")
    for d, h, tol in ((512, 1, FWD512_F64_TOL), (16, 4, FWD16_F64_TOL)):
        reads = {seq: fwd_error_vs_float64(device, (1, seq, h, d))
                 for seq in (1024, 8192)}
        log(f"[kernels] flash forward fp32 error against float64 at d = {d} "
            f"({flash_fwd_kernel(d, torch.float32)}, H = {h}), max |o - o64|: "
            + "; ".join(f"L = {seq}: {x:.3g}" for seq, x in reads.items())
            + f" (limit {tol}, and L = 8192 within twice L = 1024)")
        if not (reads[8192] < tol and reads[1024] < tol
                and reads[8192] <= 2 * reads[1024]):
            raise AssertionError(
                f"the fp32 d = {d} forward's error grows with L or passes "
                f"{tol} against float64: {reads}")
    for path, per_what in fwd_paths.items():
        per = {key: sum(r[key] * r["calls"].get(path, 0) for r in gn_rows)
               for key in ("ms", "device_ms", "host_us", "library_ms",
                           "library_device_ms", "library_host_us",
                           "bound_ms")}
        n_calls = sum(r["calls"].get(path, 0) for r in gn_rows)
        log(f"[kernels] GroupNorm forward per {per_what}, {path} ({n_calls:g} "
            f"calls, {runs[path]['launches']['group_norm_silu_fwd']} "
            f"launches): kernel ms {per['ms']:.3f}, device_ms "
            f"{per['device_ms']:.3f}, host {per['host_us'] / n_calls:.1f} us "
            f"a call; F.group_norm + F.silu ms {per['library_ms']:.3f}, "
            f"device_ms {per['library_device_ms']:.3f}, host "
            f"{per['library_host_us'] / n_calls:.1f} us a call; bound "
            f"{per['bound_ms']:.3f} ms")
    gn_bwd = train_rows["group_norm_silu_bwd"]
    for path in train_paths:
        per = {key: sum(r[key] * r["calls"].get(path, 0) for r in gn_bwd)
               for key in ("ms", "device_ms", "host_us", "library_ms",
                           "library_device_ms", "library_host_us",
                           "bound_ms")}
        n_calls = sum(r["calls"].get(path, 0) for r in gn_bwd)
        launches = (runs[path]["launches"]["group_norm_silu_bwd"]
                    / runs[path]["steps"])
        log(f"[kernels] GroupNorm backward per {path} micro-step "
            f"({n_calls:g} calls, {launches:g} launches): kernel ms "
            f"{per['ms']:.3f}, device_ms {per['device_ms']:.3f}, host "
            f"{per['host_us'] / n_calls:.1f} us a call; autograd through "
            f"F.group_norm (+ F.silu) ms {per['library_ms']:.3f}, device_ms "
            f"{per['library_device_ms']:.3f}, host "
            f"{per['library_host_us'] / n_calls:.1f} us a call; bound "
            f"{per['bound_ms']:.3f} ms")
    for path, per_what in fwd_paths.items():
        for d in (16, 64, 512):
            rows = [r for r in flash_rows
                    if r["shape"][3] == d and path in r["calls"]]
            per = {key: sum(r[key] * r["calls"][path] for r in rows)
                   for key in ("ms", "device_ms", "library_ms",
                               "library_device_ms", "bound_ms")}
            log(f"[kernels] flash forward per {per_what} at d = {d}, {path} "
                f"({sum(r['calls'][path] for r in rows):g} calls): "
                + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))
    for name, rows in (("flash_attn_fwd", flash_rows),
                       ("flash_attn_fwd_lse", train_rows["flash_attn_fwd_lse"])):
        for r in rows:
            if r["shape"][3] == 16:
                log(f"[kernels] flash forward d = 16 per call, {name} "
                    f"{r['shape']} ({r['kernel']}; calls "
                    f"{json.dumps(r['calls'])}): {r['ms']:.4f} ms, device "
                    f"{r['device_ms']:.4f}, host {r['host_us']:.1f} us; bound "
                    f"{r['bound_ms']:.4f} ({r['bound_by']}), exponentials' "
                    f"floor {r['softmax_bound_ms']:.4f}; SDPA "
                    f"{r['library_ms']:.4f} (device "
                    f"{r['library_device_ms']:.4f}); max|diff| "
                    f"{r.get('flash_tol', r)['max_abs_err']:.3g} of limit "
                    f"{r.get('flash_tol', r)['tol']:.3g}")
    for r in flash_rows:
        if r["shape"][4] == "bfloat16":
            log(f"[kernels] flash bf16 forward per call {r['shape'][:4]} "
                f"({r['kernel']}, {r['calls'].get('serve_bf16', 0):g} an "
                f"image): {r['ms']:.4f} ms (device {r['device_ms']:.4f}); "
                f"SDPA bf16 {r['library_ms']:.4f} (device "
                f"{r['library_device_ms']:.4f}); bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}), exponentials' floor "
                f"{r['softmax_bound_ms']:.4f}; max|diff| "
                f"{r['max_abs_err']:.3g} of limit {r['tol']:.3g}")
    for r in flash_rows + gn_rows:
        calls = {p: c for p, c in r["calls"].items() if p.startswith("partition")}
        if calls:
            # bf16 GroupNorm rows are held relative to max |plain| (and
            # their planted fault reads so too)
            err = (f"max|diff|/max {r['max_rel_err']:.3g}" if "max_rel_err" in r
                   else f"max|diff| {r['max_abs_err']:.3g}")
            log(f"[kernels] batched serving row {r['shape']}: calls a run "
                f"{json.dumps(calls)}; ms {r['ms']:.4f}, device_ms "
                f"{r['device_ms']:.4f}, bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}), library ms {r['library_ms']:.4f} "
                f"(device {r['library_device_ms']:.4f}), plain ms "
                f"{r['plain_ms']:.4f}; {err} of limit {r['tol']}, planted "
                f"fault {r['fault_err']:.3g}")
    log(f"[kernels] SDPA's backend at the VAE's d = 512 in fp32: "
        f"{sdpa_backend((2, 4096, 1, 512), device)}")
    for r in flash_rows + gn_rows:
        calls = {p: c for p, c in r["calls"].items() if p.startswith("tiled")}
        if calls:
            log(f"[kernels] tiled serving row {r['shape']}: calls a run "
                f"{json.dumps(calls)}; ms {r['ms']:.4f}, device_ms "
                f"{r['device_ms']:.4f}, bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}), library ms {r['library_ms']:.4f} "
                f"(device {r['library_device_ms']:.4f}), plain ms "
                f"{r['plain_ms']:.4f}; fault {r['fault_err']:.3g}")
    return lines + rans_kernel_lines(device, runs)


def lane_step_ms(device, table, tabs) -> dict:
    """The serial chain of one lane alone: a pass of LANE_CHAIN_STEPS
    symbols at K = 1 through each lane kernel; ms a step."""
    rng = np.random.default_rng(0)
    n = LANE_CHAIN_STEPS
    idx = rng.integers(0, table.ncdfs, n).astype(np.int32)
    sym = (table.offset[idx] + rng.integers(0, 1 << 30, n)
           % np.maximum(table.length[idx] - 2, 1)).astype(np.int32)
    idx_t = torch.from_numpy(idx)[None].to(device)
    w1, n1 = device_rans.lanes_from_bytes(
        *rans_encode_interleaved(sym, idx, [n], 1, table))
    w1 = torch.from_numpy(w1.astype(np.int32))[None].to(device)
    n1 = torch.from_numpy(n1)[None].to(device)
    s1 = device_rans.init_lane_state(w1, n1)
    w2, n2 = device_rans.shared_words_from_bytes(
        rans_encode_interleaved_shared(sym, idx, [n], 1, table))
    w2 = torch.from_numpy(w2.astype(np.int32))[None].to(device)
    n2 = torch.tensor([n2], dtype=torch.int32, device=device)
    s2 = device_rans.init_shared_state(w2, n2, 1)
    steps = device_rans.build_pass_steps([torch.from_numpy(sym)[None]],
                                         [torch.from_numpy(idx)[None]], 1)
    steps = [t.to(device) for t in steps]
    fns = {"rans_decode_lanes": lambda: device_rans.decode_pass(
               tabs, w1, n1, *s1, idx_t, n),
           "rans_decode_shared": lambda: device_rans.decode_pass_shared(
               tabs, w2, n2, *s2, idx_t, n),
           "rans_encode_lanes": lambda: device_rans.encode_lanes(
               tabs, *steps, 2 * n + 64)}
    return {k: cuda_ms(fn, reps=3) / n for k, fn in fns.items()}


def chain_latency_ns(device) -> dict:
    """ns of one link of each dependent chain the lane kernels walk, on the
    card, by `rans_chain_probe` (one thread): "load", a gather at the index
    the last one read, over a single random cycle through CHASE_INTS int32
    (the LUT's 8 MiB: L1 misses, L2 hits once swept); "divide", the
    encoder's slot-code update on the last one's state. Each is the time of
    2n links less that of n, over n."""
    lib = ctypes.CDLL(str(build.build_device_rans()))
    fn = lib.rdeic_rans_chain_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
    order = np.random.default_rng(0).permutation(CHASE_INTS)
    nxt = np.empty(CHASE_INTS, np.int32)
    nxt[order] = np.roll(order, -1)
    nxt = torch.from_numpy(nxt).to(device)
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    nxt.sum().item()  # the sweep that brings the chain into L2
    out = {}
    for mode, name in enumerate(("load", "divide")):
        def run(n, mode=mode):
            err = fn(nxt.data_ptr(), n, mode, 40503, 7, sink.data_ptr(),
                     stream)
            if err:
                raise RuntimeError(f"rans_chain_probe: error {err}")

        ms = {n: cuda_ms(lambda n=n: run(n), reps=3)
              for n in (CHASE_LINKS, 2 * CHASE_LINKS)}
        out[name] = (ms[2 * CHASE_LINKS] - ms[CHASE_LINKS]) / CHASE_LINKS * 1e6
    return out


def rans_kernel_lines(device, runs) -> list:
    """The lane kernels' JSON lines: each replays the calls of its path's
    image (phase 3e, recorded), timed back to back (`ms`) and behind a
    sleep (`device_ms`); `plain_ms` is the plain version on the CPU (its
    only device) over the same calls; `bound_ms` the bytes the calls must
    move (indexes and symbols or steps, the words read or written, the
    state) at 3.35 TB/s; `serial_chain_ms` the chain a lane cannot shorten:
    the calls' steps times the dependent links of a step (CHAIN_LINKS) at
    the card's latency of each (`chain_latency_ns`). `one_lane_step_ms`, the
    kernel's own step at K = 1 (`lane_step_ms`), is a diagnostic only. No
    library call computes this function (`library_ms` null)."""
    table = CdfTable(*gaussian.build_cdf_tables(gaussian.get_scale_table()))
    tabs = device_rans.DeviceRansTables(table, device)
    step = lane_step_ms(device, table, tabs)
    latency = chain_latency_ns(device)
    log(f"[kernels] the card's dependent-chain latencies (rans_chain_probe, "
        f"one thread): {json.dumps(latency)} ns a link")
    lines = []
    for name, (fn_name, replaces, path) in RANS_ROWS.items():
        run = runs[path]
        encode = fn_name == "encode_lanes"
        calls = run["checks"]["encode_calls" if encode else "calls"]
        real = getattr(device_rans, fn_name)

        def replay(calls=calls, real=real):
            for args, _ in calls:
                real(*args)

        ms = cuda_ms(replay, reps=5)
        dev, host = device_ms(replay, reps=5)
        nbytes, t_total, shapes = 0, 0, {}
        for args, out in calls:
            if encode:
                _, sym_steps, _, _, _ = args
                t, b, k = sym_steps.shape
                nbytes += 9 * sym_steps.numel() + 8 * out[1].numel() \
                    + 4 * int(out[1].sum())
            else:
                _, _, _, state, ptr, idx, _ = args
                b, k = state.shape
                t = idx.shape[1] // k
                read = int((out[1][1].long() - ptr.long()).sum())
                nbytes += 8 * idx.numel() + 4 * read + 24 * state.numel()
            t_total += t
            shapes[f"{b}x{k}x{t}"] = shapes.get(f"{b}x{k}x{t}", 0) + 1
        check = run["checks"]["encode"] if encode else run["checks"]
        plain = check["plain_ms"]
        link, links = CHAIN_LINKS[name]
        chain = t_total * links * latency[link] * 1e-6
        row = {"name": name, "route": "cuda",
               "source": "rdeic_torch/csrc/device_rans.cu",
               "replaces": replaces, "path": path,
               "launches": run["launches"][name],
               "launches_by_path": {p: r["launches"][name]
                                    for p, r in runs.items()},
               "max_abs_err": check["max_abs_err"], "ms": ms, "device_ms": dev,
               "host_ms": host * len(calls), "plain_ms": plain,
               "plain_device": "cpu",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "library_ms": None, "serial_chain_ms": chain,
               "chain_links_a_step": links, "chain_link_ns": latency[link],
               "one_lane_step_ms": step[name], "steps": t_total,
               "calls_by_shape_bxkxt": shapes}
        log(f"[kernels] {name} ({path}, {len(calls)} calls an image): ms "
            f"{ms:.4f}, device_ms {dev:.4f}; bound {row['bound_ms']:.5f} "
            f"(bytes), serial chain {chain:.4f} ({t_total} steps x {links} "
            f"dependent {link} link(s) at {latency[link]:.1f} ns; the kernel "
            f"at K = 1 takes {step[name] * 1e3:.3f} us a step); plain "
            f"version on the CPU {plain:.1f} ms; no library call")
        lines.append(row)
    return lines


# -- multi-device: phases 15-18 ----------------------------------------------------
DDP_STEPS = 2  # counted micro-steps of [ddp_nccl] (after a warm-up) and
# [ddp_gloo_2]; accumulation 2, so one AdamW update falls in them
DDP_ACCUMULATE = 2
# a gradient that is 0 but for rounding (a bias before a GroupNorm) is held
# against this share of the largest (tests/test_torch_port_train_model.py)
GRAD_FLOOR = 1e-5
GLOO_WORLD = 2
GLOO_TIMEOUT_S = 420  # the whole [ddp_gloo_2] child, start to exit


def ddp_images(seed: int, n: int) -> list:
    """`n` global batches of TRAIN_CONFIG's B = 2, 512x512 [-1, 1] images."""
    rng = np.random.default_rng(seed + 23)
    hw = TRAIN_CONFIG["out_size"]
    return [rng.uniform(-1, 1, (TRAIN_CONFIG["batch_size"], hw, hw, 3))
            .astype(np.float32) for _ in range(n)]


def time_all_reduces(trainer) -> list:
    """Wrap `trainer`'s all-reduce: each call appends (bytes, start event,
    end event, host seconds); the events bracket the call on the current
    stream, which waits for the collective."""
    calls, real = [], trainer._all_reduce

    def timed(flat, group=None):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        real(flat, group)
        end.record()
        calls.append((flat.numel() * flat.element_size(), start, end,
                      time.perf_counter() - t0))

    trainer._all_reduce = timed
    return calls


def all_reduce_reads(calls: list, steps: int) -> dict:
    """Per micro-step: the gradients' all-reduce (the first call of a step:
    bytes, device ms) and the logs' (the second), from `time_all_reduces`."""
    torch.cuda.synchronize()
    grads, logs = calls[0::2], calls[1::2]
    return {"grad_bytes": grads[0][0], "log_bytes": logs[0][0],
            "grad_ms": [s.elapsed_time(e) for _, s, e, _ in grads],
            "log_ms": [s.elapsed_time(e) for _, s, e, _ in logs],
            "grad_host_ms": [h * 1e3 for *_, h in grads],
            "calls_per_step": len(calls) / steps}


def trainable_state(trainer, model) -> dict:
    """Copies of the trainable weights, their AdamW first moments and the
    code usage."""
    return {"params": {k: p.detach().clone() for k, p in trainer.params.items()},
            "exp_avg": {k: trainer.optimizer.state[p]["exp_avg"].clone()
                        for k, p in trainer.params.items()
                        if "exp_avg" in trainer.optimizer.state.get(p, {})},
            "prob": model.vq_embed_prob.clone()}


def phase_ddp_nccl(model, device, seed: int) -> dict:
    """Phase 15, [ddp_nccl]: a world of one NCCL rank (a FileStore, no
    port) around the data-parallel `Trainer` of the full-width bf16
    independent model: B = 2, 512x512, one warm-up and DDP_STEPS counted
    micro-steps at accumulation DDP_ACCUMULATE, against the plain `Trainer`
    from the same weights, batches and noise, both under cuDNN's
    deterministic algorithms. Gate: logs, grad_norm, the trainable weights,
    AdamW's moments and the codebook and its usage bit-equal; launches as
    the structure says."""
    imgs = [torch.from_numpy(x).to(device)
            for x in ddp_images(seed, 1 + DDP_STEPS)]
    start = {k: p.detach().clone()
             for k, p in trainable_parameters(model).items()}
    prob = model.vq_embed_prob.clone()

    def run(mesh) -> dict:
        with torch.no_grad():
            for k, p in trainable_parameters(model).items():
                p.copy_(start[k])
            model.vq_embed_prob.copy_(prob)
        trainer = Trainer(model, learning_rate=TRAIN_CONFIG["learning_rate"],
                          accumulate_grad_batches=DDP_ACCUMULATE,
                          frozen_dtype=BF16, mesh=mesh)
        reduces = time_all_reduces(trainer) if mesh is not None else []
        gen = torch.Generator(device=device).manual_seed(seed)
        with full_fp32(deterministic=True):
            logs = [trainer.step(imgs[0], generator=gen)]
            del reduces[:]
            reset_counters()
            step_ms = []
            for img in imgs[1:]:
                out, ms = host_ms(lambda: trainer.step(img, generator=gen))
                logs.append(out)
                step_ms.append(ms)
        launches, shapes = read_counters()
        out = {"logs": logs, "step_ms": step_ms, "launches": launches,
               "shapes": shapes, **trainable_state(trainer, model)}
        if reduces:
            out["reduce"] = all_reduce_reads(reduces, DDP_STEPS)
        return out

    plain = run(None)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh()
            if not (mesh.distributed and mesh.shape == {"dp": 1, "tp": 1}):
                raise AssertionError(f"[ddp_nccl] mesh {mesh}")
            ddp = run(mesh)
        finally:
            dist.destroy_process_group()
    differ = [f"step {i} {k}" for i, (a, b) in enumerate(zip(ddp["logs"],
                                                             plain["logs"]))
              for k in b if not torch.equal(a[k], b[k])]
    for group in ("params", "exp_avg"):
        differ += [f"{group} {k}" for k, v in plain[group].items()
                   if not torch.equal(ddp[group][k], v)]
    if not torch.equal(ddp["prob"], plain["prob"]):
        differ.append("vq_embed_prob")
    want = {**dict.fromkeys(KERNEL_FNS, 0),
            **{k: v * DDP_STEPS
               for k, v in train_launches_per_step(model).items()}}
    red = ddp["reduce"]
    log(f"[ddp_nccl] bf16 independent, B = {TRAIN_CONFIG['batch_size']}, "
        f"{TRAIN_CONFIG['out_size']}x{TRAIN_CONFIG['out_size']}, accumulation "
        f"{DDP_ACCUMULATE}, NCCL world of 1: micro-steps "
        f"{json.dumps(ddp['step_ms'])} ms (plain Trainer "
        f"{json.dumps(plain['step_ms'])} ms); all-reduce per micro-step: "
        f"gradients {red['grad_bytes']} bytes in {json.dumps(red['grad_ms'])} "
        f"ms (CUDA events), logs {red['log_bytes']} bytes in "
        f"{json.dumps(red['log_ms'])} ms; losses "
        f"{json.dumps([x['loss'].item() for x in ddp['logs']])}")
    log(f"[ddp_nccl] launches {json.dumps(ddp['launches'])}; from the "
        f"structure {json.dumps(want)}")
    if differ:
        raise AssertionError(f"[ddp_nccl] not bit-equal to the plain Trainer: "
                             f"{len(differ)} items, first {differ[:8]}")
    check_launches("ddp_nccl", ddp["launches"], want)
    log(f"[ddp_nccl] logs, grad_norm, {len(plain['params'])} trainable "
        f"tensors, AdamW's moments, the codebook and its usage bit-equal to "
        f"the plain Trainer's")
    return {"ms": float(np.mean(ddp["step_ms"])), "step_ms": ddp["step_ms"],
            "plain_step_ms": plain["step_ms"], "steps": DDP_STEPS,
            "launches": ddp["launches"], "shapes": ddp["shapes"],
            "reduce": red}


def weights_digest(model) -> torch.Tensor:
    """`tensors_digest` of the model's state dict."""
    return tensors_digest(model.state_dict().values())


def tensors_digest(tensors) -> torch.Tensor:
    """An int64 a tensor on the CPU: the sum of its words (16- or 32-bit),
    each times an odd weight from its position, with wrap-around; a tensor
    that differs anywhere reads otherwise (but for a 2^-64 chance)."""
    out = []
    for v in tensors:
        flat = v.detach().contiguous().reshape(-1)
        words = flat.view(torch.int16 if flat.element_size() == 2
                          else torch.int32).to(torch.int64)
        weight = (torch.arange(words.numel(), device=words.device) % 65521) * 2 + 1
        out.append((words * weight).sum())
    return torch.stack(out).cpu()


def broadcast_equal(x: torch.Tensor) -> bool:
    """Whether this rank's CPU tensor equals rank 0's (broadcast)."""
    ref = x.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(ref, x))


def copy_sets(codebook: torch.Tensor) -> torch.Tensor:
    """[K] set ids of the codes: codes within 1e-3 (max |diff|) of the first
    code of a set not yet taken join it. The codebook update re-seeds each
    unused code from its closest row (0.999 of the row), so the codes
    closest to one row become copies, within 1e-3 of each other even after
    a later pull of e^-10 of a row's distance, and distinct rows lie ~1
    apart."""
    ids = torch.full((codebook.shape[0],), -1, dtype=torch.long,
                     device=codebook.device)
    n = 0
    while bool((ids < 0).any()):
        first = int((ids < 0).nonzero()[0])
        near = ((codebook - codebook[first]).abs().amax(1) < 1e-3) & (ids < 0)
        ids[near] = n
        n += 1
    return ids


def codebook_reads(got: dict, want: dict, codebook: torch.Tensor) -> dict:
    """Max relative |got - want| of the code usage summed over each set of
    copies of one code (`copy_sets`): a row nearest to copies takes any of
    them at another batch size, its hyper latent an ulp away."""
    ids = copy_sets(codebook)
    n = int(ids.max()) + 1
    g, w = (torch.zeros(n, dtype=torch.float64, device=ids.device).index_add_(
        0, ids, x["prob"].double()) for x in (got, want))
    rel = ((g - w).abs() / w.abs().clamp(min=1e-30)).max().item()
    return {"usage_rel": rel, "copy_sets": n}


def hold_to_plain(mine: dict, logs: list, ref: dict, moves: dict,
                  lr: float) -> tuple[dict, list]:
    """(reads, failed gates) of a rank's steps (`mine`: its
    `trainable_state`, whole tensors; `logs`) against the plain Trainer's
    (`ref`, with each mean gradient's move under the +-1e-6 nudge of the
    images, `moves`): logs within 1e-5, AdamW's first moment within 1e-4 of
    each tensor's max (GRAD_FLOOR of the largest at least) or twice its
    nudge move, the weights within 2 lr and to 1e-6 where the gradient is
    firm, the code usage to 1e-6 over each set of copied codes."""
    reads = {"logs": max(abs(a[k].item() - b[k].item())
                         / max(abs(b[k].item()), 1e-30)
                         for a, b in zip(logs, ref["logs"]) for k in b)}
    top = max(v.abs().max().item() for v in ref["exp_avg"].values())
    grad_err, over, weight_err, firm_err = {}, {}, 0.0, 0.0
    for k, w in ref["exp_avg"].items():
        scale = max(w.abs().max().item(), GRAD_FLOOR * top)
        grad_err[k] = (mine["exp_avg"][k] - w).abs().max().item() / scale
        if grad_err[k] > max(1e-4, 2 * moves[k]):
            over[k] = (grad_err[k], moves[k])
    for k, w in ref["params"].items():
        d = (mine["params"][k] - w).abs()
        weight_err = max(weight_err, d.max().item())
        g = ref["exp_avg"][k].abs() if k in ref["exp_avg"] else None
        if g is not None:
            firm = g > 1e-2 * max(g.max().item(), GRAD_FLOOR * top)
            if firm.any():
                atol = 1e-5 if k == "compression.quantize.embedding" else 1e-7
                firm_err = max(firm_err, ((d - atol) / w.abs().clamp(
                    min=1e-30))[firm].max().item())
    worst = [(k, e, moves[k]) for k, e in
             sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]]
    reads.update(grad_rel=worst[0][1], worst_grads_and_moves=worst,
                 over_limit=over,
                 weight_abs=weight_err, firm_weight_rel=firm_err,
                 **codebook_reads(mine, ref, ref["params"][
                     "compression.quantize.embedding"]))
    fails = []
    if reads["logs"] > 1e-5:
        fails.append(f"logs differ by {reads['logs']:.3g} (limit 1e-5)")
    if over:
        fails.append(f"mean gradients differ beyond 1e-4 of max and twice "
                     f"their nudge moves: {over}")
    if weight_err > 2 * lr * (1 + 1e-3) + 1e-7 or firm_err > 1e-6:
        fails.append(f"weights differ by {weight_err:.3g} (limit 2 lr), "
                     f"{firm_err:.3g} relative where the gradient is firm")
    if reads["usage_rel"] > 1e-6:
        fails.append(f"code usage differs by {reads['usage_rel']:.3g}")
    return reads, fails


def plain_reference(model, imgs: list, lr: float, seed: int) -> tuple:
    """The plain Trainer's steps on `imgs` (accumulation DDP_ACCUMULATE,
    noise from `seed`), from `model`'s weights and back to them: (its logs
    and `trainable_state`, the move of each mean gradient when the images
    alone are nudged by +-1e-6: large behind LeakyReLU's kinks, where an
    input within rounding of 0 takes either slope (the refine test's
    rule))."""
    start = {k: p.detach().clone()
             for k, p in trainable_parameters(model).items()}
    prob = model.vq_embed_prob.clone()

    def restore():
        with torch.no_grad():
            for k, p in trainable_parameters(model).items():
                p.copy_(start[k])
            model.vq_embed_prob.copy_(prob)

    def plain(scale: float) -> dict:
        """The plain steps on the images times `scale`, from the start."""
        restore()
        trainer = Trainer(model, learning_rate=lr,
                          accumulate_grad_batches=DDP_ACCUMULATE)
        gen = torch.Generator(device=imgs[0].device).manual_seed(seed)
        out = {"logs": [], "step_ms": []}
        with full_fp32():
            for img in imgs:
                logs, ms = host_ms(lambda: trainer.step(img * scale,
                                                        generator=gen))
                out["logs"].append(logs)
                out["step_ms"].append(ms)
        out.update(trainable_state(trainer, model))
        return out

    ref = plain(1.0)
    moves = dict.fromkeys(ref["exp_avg"], 0.0)
    for eps in (1e-6, -1e-6):
        for k, g in plain(1 + eps)["exp_avg"].items():
            w = ref["exp_avg"][k]
            moves[k] = max(moves[k], ((g - w).abs().max()
                                      / w.abs().max().clamp(min=1e-30)).item())
    restore()
    del start
    torch.cuda.empty_cache()
    return ref, moves


def gloo_rank(args) -> int:
    """A rank of [ddp_gloo_2] (run as `chip_smoke.py --gloo-rank R ...` by
    phase 16): full-width fp32 independent training on the one card over a
    gloo world of GLOO_WORLD, each rank on its rows of B = 2. Rank 0 first
    runs the plain `Trainer` on the whole batch from the same weights and
    noise, and holds the ranks' steps to it; its reads go to
    `<out>/rank<R>.json`. A failed gate raises."""
    rank, world = args.gloo_rank, GLOO_WORLD
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.gloo_port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=GLOO_TIMEOUT_S // 2))
    device = resolve_device("cuda")
    t0 = time.perf_counter()
    model = make_model(device, args.seed)
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    digest = weights_digest(model)
    if not broadcast_equal(digest):
        raise AssertionError(f"[ddp_gloo_2] rank {rank} starts from other "
                             "weights than rank 0")
    imgs = [torch.from_numpy(x).to(device) for x in ddp_images(args.seed, DDP_STEPS)]
    lr = TRAIN_CONFIG["learning_rate"]
    ref = None
    if rank == 0:  # the plain Trainer on the whole batch, then back
        ref, moves = plain_reference(model, imgs, lr, args.seed)
    dist.barrier()
    mesh = make_mesh()
    trainer = Trainer(model, learning_rate=lr,
                      accumulate_grad_batches=DDP_ACCUMULATE, mesh=mesh)
    reduces = time_all_reduces(trainer)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    reset_counters()
    logs, step_ms = [], []
    with full_fp32():
        for img in imgs:
            rows = mesh.rows(img.shape[0])
            out, ms = host_ms(lambda: trainer.step(img[rows], generator=gen))
            logs.append(out)
            step_ms.append(ms)
    launches, shapes = read_counters()
    red = all_reduce_reads(reduces, DDP_STEPS)
    same_after = broadcast_equal(weights_digest(model))
    result = {"rank": rank, "rows": [mesh.rows(2).start, mesh.rows(2).stop],
              "model_s": model_s, "step_ms": step_ms, "reduce": red,
              "launches": launches,
              "shapes": {k: [[list(key), n] for key, n in v.items()]
                         for k, v in shapes.items()},
              "same_weights_after": same_after}
    want = {**dict.fromkeys(KERNEL_FNS, 0),
            **{k: v * DDP_STEPS
               for k, v in train_launches_per_step(model).items()}}
    fails = []
    if not same_after:
        fails.append("the ranks' weights differ after the steps")
    if launches != want:
        fails.append(f"launches {launches}, expected {want}")
    if ref is not None:
        reads, ref_fails = hold_to_plain(trainable_state(trainer, model), logs,
                                         ref, moves, lr)
        fails += ref_fails
        result["reads"] = reads
        result["plain_logs"] = [{k: v.item() for k, v in x.items()}
                                for x in ref["logs"]]
    result["logs"] = [{k: v.item() for k, v in x.items()} for x in logs]
    result["fails"] = fails
    Path(args.gloo_out, f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    if fails:
        raise AssertionError(f"[ddp_gloo_2] rank {rank}: {fails}")
    return 0


def spawn_ranks(tag: str, flag: str, world: int, seed: int, timeout: float,
                inputs: dict | None = None) -> tuple[list, list]:
    """`world` processes of this script (`flag R` for rank R) on the one
    card, gloo over a free local port, sharing a temporary directory
    (`--gloo-out`; `inputs`, if given, saved there as inputs.pt first):
    (exit codes, the `rank<R>.json` reads they wrote). Each rank's last
    output lines are logged under `tag`; every process is waited for or
    killed."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        if inputs is not None:
            torch.save(inputs, Path(tmp, "inputs.pt"))
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
             flag, str(r), "--gloo-port", str(port), "--gloo-out", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, out in enumerate(outs):
            for line in out.splitlines()[-40:]:
                log(f"[{tag} rank {r}] {line}")
        codes = [p.returncode for p in procs]
        results = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                   for r in range(world) if Path(tmp, f"rank{r}.json").exists()]
    return codes, results


def phase_ddp_gloo(seed: int) -> dict:
    """Phase 16, [ddp_gloo_2]: GLOO_WORLD processes of this script on the
    one card (NCCL takes no two ranks on one device), gloo over a local
    port, fp32 independent at the full width: B = 2 split 1 + 1, DDP_STEPS
    micro-steps at accumulation DDP_ACCUMULATE (`gloo_rank`). Gates (in
    the ranks; a rank that fails exits non-zero, and so does this phase):
    the ranks start from bit-equal weights (a digest rank 0 broadcasts) and
    end bit-equal; rank 0's steps against the plain Trainer's on the whole
    batch: logs (loss, grad_norm) within 1e-5, AdamW's first moment (the
    mean gradient) within 1e-4 of each tensor's max (GRAD_FLOOR of the
    largest at least), the weights within 2 lr and to 1e-6 where the
    gradient is firm (test_torch_port_train_loop's rule), the code usage
    to 1e-6 over each set of copied codes; launches per rank as the
    structure says."""
    codes, results = spawn_ranks("ddp_gloo_2", "--gloo-rank", GLOO_WORLD,
                                 seed, GLOO_TIMEOUT_S)
    for res in results:
        log(f"[ddp_gloo_2] rank {res['rank']}: reads "
            f"{json.dumps(res.get('reads'))}; fails {res['fails']}")
    if any(codes):
        raise AssertionError(f"[ddp_gloo_2] ranks exited {codes}")
    first = results[0]
    for res in results:
        log(f"[ddp_gloo_2] rank {res['rank']} rows {res['rows']}: model in "
            f"{res['model_s']:.1f} s; micro-steps {json.dumps(res['step_ms'])} "
            f"ms; all-reduce per micro-step: gradients "
            f"{res['reduce']['grad_bytes']} bytes in "
            f"{json.dumps(res['reduce']['grad_ms'])} ms (CUDA events; host "
            f"{json.dumps(res['reduce']['grad_host_ms'])} ms), logs "
            f"{res['reduce']['log_bytes']} bytes in "
            f"{json.dumps(res['reduce']['log_ms'])} ms; weights bit-equal "
            f"across ranks after: {res['same_weights_after']}")
    log(f"[ddp_gloo_2] rank 0 against the plain Trainer on B = 2: "
        f"{json.dumps(first['reads'])}; losses {[x['loss'] for x in first['logs']]}"
        f" against {[x['loss'] for x in first['plain_logs']]}")
    shapes = {k: {tuple(key): n for key, n in v} for k, v in first["shapes"].items()}
    return {"ms": float(np.mean(first["step_ms"])), "step_ms": first["step_ms"],
            "steps": DDP_STEPS, "launches": first["launches"], "shapes": shapes,
            "reduce": first["reduce"], "reads": first["reads"]}


def partition_dp_launches(model, chunks, dp: int) -> dict:
    """`partition_launches` with each micro-batch that dp divides decoded
    by dp replicas: each replica's decode launches what one call does."""
    n_gn = sum(isinstance(m, GroupNorm32) for m in model.denoiser.modules())
    want = dict.fromkeys(KERNEL_FNS, 0)
    for chunk in chunks:
        want["flash_attn_fwd"] += 1  # the VAE encoder, the whole chunk
        for j in range(0, len(chunk), PARTITION_MICRO):
            calls = dp if len(chunk[j:j + PARTITION_MICRO]) % dp == 0 else 1
            want["flash_attn_fwd"] += calls * (FLASH_PER_DENOISER_CALL_768
                                               * STEPS + 1)
            want["group_norm_silu_fwd"] += calls * n_gn * STEPS
    return want


def phase_partition_dp(model, device, seed: int, base: dict) -> dict:
    """Phase 17, [partition_dp]: phase 3c's fp32 run through `serve` with
    `replicas` (what `--dp 2` runs: each micro-batch's noise drawn on the
    first device at its size, its rows split over two replicas, a thread
    each), both replicas this card's model. Gates: every stream byte-equal
    to [partition]'s; every image within 1e-5 of it (a replica decodes
    half the rows); launches: each split micro-batch twice a decode call's."""
    items = partition_images(seed)
    chunks = make_chunks(items, PARTITION_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs, ms = host_ms(lambda: run_partition(
            model, chunks, Path(tmp), seed, replicas=[model, model]))
        peak = torch.cuda.max_memory_allocated()
        launches, shapes = read_counters()
        streams = {name: Path(tmp, f"{name}.rdeic").read_bytes()
                   for name, _ in items}
    bad = [n for n in streams if streams[n] != base["streams"][n]]
    err = max(float(np.abs(out - want).max())
              for (out, _), want in zip(outs, base["images"]))
    want = partition_dp_launches(model, chunks, 2)
    log(f"[partition_dp] dp = 2 replicas on this card, fp32: {ms:.1f} ms, "
        f"{ms / len(items):.1f} ms an image (host clock, synchronised; "
        f"[partition] {base['ms_per_image']:.1f}); peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} above the "
        f"resident); images against [partition]: max |diff| {err:.3g}; "
        f"launches {json.dumps(launches)}, from the structure "
        f"{json.dumps(want)}")
    if bad:
        raise AssertionError(f"[partition_dp] streams differ from "
                             f"[partition]'s: {bad}")
    if err > 1e-5:
        raise AssertionError(f"[partition_dp] images differ from "
                             f"[partition]'s by {err:.3g} (limit 1e-5)")
    check_launches("partition_dp", launches, want)
    return {"ms": ms, "ms_per_image": ms / len(items), "launches": launches,
            "shapes": shapes, "peak_bytes": peak, "max_abs_err": err}


def phase_tiled_mesh(model, device, seed: int, base: dict) -> dict:
    """Phase 18, [tiled_mesh]: `--use_mesh` over the one card (the CLI's
    `make_mesh()` there; here `make_mesh(devices=[device])`, the card this
    run drives): [tiled_v2]'s stream decoded again through
    `tiled_decompress_decode` with the mesh's replicas and a generator
    seeded alike. On one device nothing is padded, so the gate is
    bit-equality with [tiled_v2]'s image; launches as the decode's part of
    `tiled_launches`."""
    mesh = make_mesh(devices=[device])
    replicas = [model for _ in mesh.devices()]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "tiled.rdeic")
        path.write_bytes(base["stream"])
        gen = torch.Generator(device=device).manual_seed(seed)
        reset_counters()
        out, ms = host_ms(lambda: tiled.tiled_decompress_decode(
            model, path, steps=STEPS, tile_batch=base["tile_batch"],
            generator=gen, replicas=replicas))
        launches, shapes = read_counters()
    want = tiled_launches(model, True, base["n_tiles"], base["tile_batch"],
                          base["containers"])
    want["flash_attn_fwd"] -= -(-base["n_tiles"] // tiled.FEATURE_BATCH)
    same = bool(torch.equal(out.cpu(), base["image"]))
    log(f"[tiled_mesh] --use_mesh over the one card (dp = "
        f"{mesh.shape['dp']}): decode {ms:.1f} ms; bit-equal to [tiled_v2]: "
        f"{same}; launches {json.dumps(launches)}, from the grid "
        f"{json.dumps(want)}")
    if not same:
        raise AssertionError("[tiled_mesh] the image differs from [tiled_v2]'s")
    check_launches("tiled_mesh", launches, want)
    return {"ms": ms, "launches": launches, "shapes": shapes}


# -- tensor parallel and the export: phases 19-21 ---------------------------------
TP_WORLD = 2
TP_HW = 256  # the top level's L = 1024: flash forward, dq and dkv run under TP
TP_STEPS = 2  # counted micro-steps after a warm-up, at DDP_ACCUMULATE
TP_TIMEOUT_S = 480  # the whole [tp_gloo_2] child, start to exit
# self-attentions over >= 1024 tokens per dual-UNet call at 256x256 (UNet
# L = 1024 h5 d64 x5, control L = 1024 h4 d16 x2; L = 256 and 64 go to the
# plain product)
FLASH_PER_DENOISER_CALL_256 = 7


def tp_images(seed: int, n: int) -> list:
    """`n` global batches of B = 2 TP_HW x TP_HW [-1, 1] images."""
    rng = np.random.default_rng(seed + 29)
    return [rng.uniform(-1, 1, (TRAIN_CONFIG["batch_size"], TP_HW, TP_HW, 3))
            .astype(np.float32) for _ in range(n)]


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def time_collectives(trainer) -> dict:
    """Wrap the column-parallel layers' collectives (`parallel.tensor`: the
    forward's all-gather of the outputs, the backward's all-reduce of dX)
    and the trainer's all-reduce: each call appends (bytes, start event,
    end event, host seconds) to its kind's list; the events bracket the
    call on the current stream, which waits for it."""
    calls = {"all_gather": [], "all_reduce_dx": [], "trainer_all_reduce": []}

    def wrap(kind, real, tensor_of):
        def timed(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = real(*args)
            end.record()
            x = tensor_of(args, out)
            calls[kind].append((x.numel() * x.element_size(), start, end,
                                time.perf_counter() - t0))
            return out
        return timed

    tp_tensor.all_gather_features = wrap(
        "all_gather", tp_tensor.all_gather_features, lambda a, out: out)
    tp_tensor.all_reduce_sum = wrap(
        "all_reduce_dx", tp_tensor.all_reduce_sum, lambda a, out: out)
    trainer._all_reduce = wrap("trainer_all_reduce", trainer._all_reduce,
                               lambda a, out: a[0])
    return calls


def collective_reads(calls: dict, steps: int) -> dict:
    """Per micro-step, by kind: calls, bytes, device ms (CUDA events) and
    host ms, from `time_collectives`."""
    torch.cuda.synchronize()
    return {kind: {"calls": len(c) / steps,
                   "bytes": sum(b for b, *_ in c) / steps,
                   "ms": sum(s.elapsed_time(e) for _, s, e, _ in c) / steps,
                   "host_ms": sum(h for *_, h in c) * 1e3 / steps}
            for kind, c in calls.items()}


def decode_launches(model) -> dict:
    """Kernel launches of phase 3's decode alone (decompress, relay
    sampling, VAE decode): `serve_launches` without the VAE encoder's
    mid-block attention."""
    want = serve_launches(model)
    want["flash_attn_fwd"] -= 1
    return want


def tp_rank(args) -> int:
    """A rank of [tp_decode] and [tp_gloo_2] (run as `chip_smoke.py
    --tp-rank R ...` by phase 19): the full-width fp32 independent model
    from the seed on the one card, after `shard_params` on a dp = 1,
    tp = TP_WORLD mesh over gloo. Rank 0 first runs the plain `Trainer`
    on a whole copy (`plain_reference`). Then phase 3's stream is decoded
    under the sharded weights, and the ranks take a warm-up and TP_STEPS
    micro-steps on B = 2 TP_HW x TP_HW images; the gathered train state is
    saved, and rank 0 holds the steps to the plain ones and resumes the
    file in a tp = 1 Trainer for one more step. Reads go to
    `<out>/rank<R>.json`; a failed gate raises."""
    rank = args.tp_rank
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.gloo_port}",
                            world_size=TP_WORLD, rank=rank,
                            timeout=timedelta(seconds=TP_TIMEOUT_S // 2))
    device = resolve_device("cuda")
    model = make_model(device, args.seed)
    if not broadcast_equal(weights_digest(model)):
        raise AssertionError(f"[tp_gloo_2] rank {rank} starts from other "
                             "weights than rank 0")
    inp = torch.load(Path(args.gloo_out, "inputs.pt"), map_location=device,
                     weights_only=True)
    imgs = [torch.from_numpy(x).to(device)
            for x in tp_images(args.seed, 1 + TP_STEPS)]
    lr = TRAIN_CONFIG["learning_rate"]
    whole = None
    if rank == 0:  # the plain Trainer on a whole copy, kept for the resume
        whole = make_model(device, args.seed)
        ref, moves = plain_reference(whole, imgs, lr, args.seed)
    dist.barrier()
    mesh = make_mesh(dp=1, tp=TP_WORLD)
    whole_bytes = param_bytes(model)
    shard_params(model, mesh)
    fails = []
    result = {"rank": rank, "weight_bytes": param_bytes(model),
              "whole_weight_bytes": whole_bytes,
              "sharded_tensors": len(tp_layers(model))}

    # [tp_decode]: phase 3's stream under the sharded weights
    stream = Path(args.gloo_out, f"rank{rank}.rdeic")
    stream.write_bytes(bytes(inp["stream"].tolist()))

    def decode():
        c_latent, guide_hint = model.apply_condition_decompress(stream)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return (c_latent, guide_hint), model.decode_pipeline(
            c_latent, guide_hint, STEPS, generator=gen)

    _, warm_ms = host_ms(decode)
    reset_counters()
    (latents, out), ms = host_ms(decode)
    launches, shapes = read_counters()
    err = (out - inp["image"]).abs().max().item()
    result["decode"] = {"ms": ms, "warm_ms": warm_ms, "max_abs_err": err,
                        "launches": launches, "shapes": serial_shapes(shapes)}
    if not all(torch.equal(a, b) for a, b in zip(latents, inp["latents"])):
        fails.append("[tp_decode] decoded latents differ from phase 3's")
    if err > 1e-5:
        fails.append(f"[tp_decode] image differs from phase 3's by {err:.3g} "
                     "(limit 1e-5)")
    if launches != decode_launches(model):
        fails.append(f"[tp_decode] launches {launches}, expected "
                     f"{decode_launches(model)}")

    # [tp_gloo_2]
    trainer = Trainer(model, learning_rate=lr,
                      accumulate_grad_batches=DDP_ACCUMULATE, mesh=mesh)
    calls = time_collectives(trainer)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with full_fp32():
        logs, warm_ms = host_ms(lambda: [trainer.step(imgs[0], generator=gen)])
        for c in calls.values():
            c.clear()
        reset_counters()
        step_ms = []
        for img in imgs[1:]:
            out, ms = host_ms(lambda: trainer.step(img, generator=gen))
            logs.append(out)
            step_ms.append(ms)
    launches, shapes = read_counters()
    result.update(step_ms=step_ms, warm_ms=warm_ms, launches=launches,
                  shapes=serial_shapes(shapes),
                  collectives=collective_reads(calls, TP_STEPS))
    want = {**dict.fromkeys(KERNEL_FNS, 0),
            **{k: v * TP_STEPS for k, v in train_launches_per_step(
                model, FLASH_PER_DENOISER_CALL_256).items()}}
    if launches != want:
        fails.append(f"[tp_gloo_2] launches {launches}, expected {want}")
    replicated = {k: p for k, p in trainer.params.items()
                  if k not in trainer.sharded}
    result["replicated_equal"] = broadcast_equal(
        tensors_digest(replicated.values()))
    if not result["replicated_equal"]:
        fails.append("[tp_gloo_2] the ranks' replicated weights differ")
    # the gathered state (every rank joins the gathers)
    names = list(trainer.params)
    moments = trainer._map_moments(
        trainer.optimizer.state_dict(),
        lambda k, x: gather_blocks(x, trainer.sharded[k]))["state"]
    state = gather_state_dict(model)
    mine = {"params": {k: state[k] for k in names},
            "exp_avg": {names[i]: st["exp_avg"] for i, st in moments.items()},
            "prob": model.vq_embed_prob.clone()}
    ckpt = Path(args.gloo_out, f"step_{trainer.step_count}.pt")
    trainer.save(ckpt)
    dist.barrier()
    if rank == 0:
        reads, ref_fails = hold_to_plain(mine, logs, ref, moves, lr)
        fails += [f"[tp_gloo_2] {f}" for f in ref_fails]
        result["reads"] = reads
        result["plain_logs"] = [{k: v.item() for k, v in x.items()}
                                for x in ref["logs"]]
        result["plain_step_ms"] = ref["step_ms"]
        # the gathered file resumes at tp = 1 and steps there
        resumed = Trainer(whole, learning_rate=lr,
                          accumulate_grad_batches=DDP_ACCUMULATE)
        resumed.load(ckpt)
        result["ckpt_bytes"] = ckpt.stat().st_size
        if resumed.step_count != 1 + TP_STEPS or not all(
                torch.equal(p, mine["params"][k])
                for k, p in resumed.params.items()):
            fails.append("[tp_gloo_2] the tp = 1 resume differs from the "
                         "gathered state")
        with full_fp32():
            more = resumed.step(imgs[0], generator=gen)
        result["resumed_loss"] = more["loss"].item()
        if not all(torch.isfinite(v) for v in more.values()):
            fails.append(f"[tp_gloo_2] the resumed step gave {more}")
    result["logs"] = [{k: v.item() for k, v in x.items()} for x in logs]
    result["fails"] = fails
    Path(args.gloo_out, f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    if fails:
        raise AssertionError(f"[tp_gloo_2] rank {rank}: {fails}")
    return 0


def serial_shapes(shapes: dict) -> dict:
    """`read_counters`' shapes as JSON lists."""
    return {k: [[list(key), n] for key, n in v.items()]
            for k, v in shapes.items()}


def phase_tp_gloo(seed: int, serve: dict) -> tuple[dict, dict]:
    """Phases 19 and 20, [tp_gloo_2] and [tp_decode]: TP_WORLD processes of
    this script on the one card (`tp_rank`), gloo over a local port, the
    full-width fp32 independent model from the seed after `shard_params`
    at dp = 1, tp = TP_WORLD. [tp_decode] decodes phase 3's stream: the
    latents bit-equal, the image within 1e-5 of phase 3's, launches as
    phase 3's decode. [tp_gloo_2] takes a warm-up and TP_STEPS micro-steps
    at DDP_ACCUMULATE (B = 2, TP_HW x TP_HW, so the top level's L = 1024
    runs the flash forward, dq and dkv): rank 0 against the plain Trainer
    on the same weights, batch and noise (`hold_to_plain`: logs 1e-5,
    gathered gradients 1e-4 of max or twice their nudge move, weights
    2 lr), the ranks' replicated weights bit-equal, launches from the
    structure; the gathered step_N.pt resumes in a tp = 1 Trainer, which
    steps. Printed: each rank's weight bytes against tp = 1's, the
    collectives' calls, bytes and ms a micro-step, ms a micro-step."""
    inputs = {"stream": torch.tensor(list(serve["stream"]), dtype=torch.uint8),
              "image": serve["image"].cpu(),
              "latents": [x.cpu() for x in serve["latents"]]}
    codes, results = spawn_ranks("tp_gloo_2", "--tp-rank", TP_WORLD, seed,
                                 TP_TIMEOUT_S, inputs)
    for res in results:
        log(f"[tp_gloo_2] rank {res['rank']}: reads "
            f"{json.dumps(res.get('reads'))}; fails {res['fails']}")
    if any(codes):
        raise AssertionError(f"[tp_gloo_2] ranks exited {codes}")
    first = results[0]
    for res in results:
        dec = res["decode"]
        log(f"[tp_decode] rank {res['rank']}: phase 3's stream decoded under "
            f"the sharded weights in {dec['ms']:.1f} ms (warm-up "
            f"{dec['warm_ms']:.1f}); image within {dec['max_abs_err']:.3g} of "
            f"phase 3's; launches {json.dumps(dec['launches'])}")
        log(f"[tp_gloo_2] rank {res['rank']}: weights {res['weight_bytes']} "
            f"bytes against {res['whole_weight_bytes']} at tp = 1 "
            f"({res['sharded_tensors']} tensors sharded); warm-up "
            f"{res['warm_ms']:.1f} ms, micro-steps {json.dumps(res['step_ms'])} "
            f"ms; collectives per micro-step {json.dumps(res['collectives'])}; "
            f"replicated weights bit-equal across ranks: "
            f"{res['replicated_equal']}")
    log(f"[tp_gloo_2] rank 0 against the plain Trainer on B = 2, "
        f"{TP_HW}x{TP_HW} (its micro-steps {json.dumps(first['plain_step_ms'])}"
        f" ms, warm-up first): {json.dumps(first['reads'])}; losses "
        f"{[x['loss'] for x in first['logs']]} against "
        f"{[x['loss'] for x in first['plain_logs']]}; the gathered "
        f"checkpoint ({first['ckpt_bytes']} bytes) resumed at tp = 1, loss "
        f"{first['resumed_loss']:.6g} a step later")

    def shapes_of(serial):
        return {k: {tuple(key): n for key, n in v} for k, v in serial.items()}

    train = {"ms": float(np.mean(first["step_ms"])), "step_ms": first["step_ms"],
             "steps": TP_STEPS, "launches": first["launches"],
             "shapes": shapes_of(first["shapes"]),
             "collectives": first["collectives"], "reads": first["reads"]}
    dec = first["decode"]
    decode = {"ms": dec["ms"], "launches": dec["launches"],
              "shapes": shapes_of(dec["shapes"])}
    return train, decode


def npz_dtypes(path: Path) -> set:
    """The dtypes of an .npz file's arrays, from their headers alone."""
    kinds = set()
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                major, _ = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if major == 1
                        else np.lib.format.read_array_header_2_0)
                kinds.add(str(read(f)[2]))
    return kinds


def phase_export(device, seed: int) -> None:
    """Phase 21, [export]: `save_params_npz` of the full-width fp32 model
    from the seed to a file, then `load_npz_weights` into a fresh model:
    state dicts bit-equal. Again after the bf16 recipe's casts of the same
    model (`set_compute_dtype(bf16)`, its frozen tensors stored in bf16):
    every leaf is written fp32, and a bf16 tensor's fp32 values come back
    to the same bf16 bits."""
    model = make_model(device, seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "params.npz")
        for tag in ("fp32", "bf16 frozen"):
            if tag != "fp32":
                model.set_compute_dtype(BF16, cast_weights=False)
                cast_frozen(model, BF16)
            _, save_ms = host_ms(lambda: save_params_npz(path, model))
            fresh = RDEIC(**MODEL_CONFIG, device="meta")
            if tag != "fp32":
                fresh.set_compute_dtype(BF16, cast_weights=False)
                cast_frozen(fresh, BF16)
            fresh.to_empty(device=device)
            _, load_ms = host_ms(lambda: load_npz_weights(fresh, path))
            kinds = npz_dtypes(path)
            got, want = fresh.state_dict(), model.state_dict()
            differ = [k for k, v in want.items()
                      if got[k].dtype != v.dtype or not torch.equal(got[k], v)]
            n_bf16 = sum(v.dtype == BF16 for v in want.values())
            log(f"[export] {tag}: save_params_npz {path.stat().st_size} bytes "
                f"in {save_ms:.1f} ms, load_npz_weights {load_ms:.1f} ms; "
                f"{len(want)} tensors ({n_bf16} bf16), file dtypes "
                f"{sorted(kinds)}; differ: {differ[:5]}")
            if differ or kinds != {"float32"} or (tag != "fp32") != (n_bf16 > 0):
                raise AssertionError(
                    f"[export] {tag}: {len(differ)} tensors differ after the "
                    f"round trip, file dtypes {kinds}, {n_bf16} bf16 tensors")
            del fresh, got
    del model
    torch.cuda.empty_cache()


class PhaseClock:
    """Seconds between marks, by the name of the phases they close."""

    def __init__(self):
        self.last, self.marks = time.perf_counter(), {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.marks[name] = round(now - self.last, 1)
        self.last = now


def main() -> int:
    ap = argparse.ArgumentParser(description="rdeic_torch smoke run on one GPU")
    ap.add_argument("--seed", type=int, default=0)
    # a rank of phase 16, started by the phase itself
    ap.add_argument("--gloo-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-out", default=None, help=argparse.SUPPRESS)
    # a rank of phases 19 and 20, started by phase 19
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.gloo_rank is not None:
        return gloo_rank(args)
    if args.tp_rank is not None:
        return tp_rank(args)
    device = resolve_device("cuda")
    clock = PhaseClock()
    phase_environment()
    phase_build()
    clock.mark("build")
    t0 = time.perf_counter()
    model = make_model(device, args.seed)
    torch.cuda.synchronize()
    log(f"[main] full-width model on the card in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.0f} M params)")
    runs = {"serve": phase_main_path(model, device, args.seed)}
    serve_runs, bf16 = phase_serve_options(model, device, args.seed)
    runs.update(serve_runs)
    clock.mark("serve")
    runs["partition"] = phase_partition(model, device, args.seed, "partition")
    runs["partition_bf16"] = phase_partition(bf16, device, args.seed,
                                             "partition_bf16")
    check_partition_bf16(model, runs)
    phase_partition_clip(model, device, args.seed)
    clock.mark("partition")
    runs["partition_dp"] = phase_partition_dp(model, device, args.seed,
                                              runs["partition"])
    clock.mark("partition_dp")
    for tag, m, v2, tile_batch, settings in (
            ("tiled_v2", model, True, 4, {}),
            ("tiled_v2_bf16", bf16, True, 4, {}),
            ("tiled_v1", model, False, 0, {"RDEIC_RANS_LANES": "128"})):
        runs[tag] = phase_tiled(m, device, args.seed, tag, v2, tile_batch,
                                settings)
    clock.mark("tiled")
    runs["tiled_mesh"] = phase_tiled_mesh(model, device, args.seed,
                                          runs["tiled_v2"])
    clock.mark("tiled_mesh")
    runs.update(phase_lanes(model, device, args.seed, runs["serve"]))
    clock.mark("lanes")
    runs.update(phase_harness(model, device, args.seed, runs["serve"]))
    clock.mark("harness")
    phase_reference(model, bf16, device, args.seed)
    del bf16
    phase_validate_reference(model, device, args.seed)
    clock.mark("reference")
    phase_train_reference(model, device, args.seed)
    runs["train"] = phase_training(model, device, args.seed)
    refine = make_refine_model(model, args.seed)
    phase_train_reference(refine, device, args.seed)
    runs["refine"] = phase_training(refine, device, args.seed)
    clock.mark("train and refine")
    runs["validate"] = phase_validate(model, device, args.seed,
                                      "a, fp32 independent", want_bf16=False)
    phase_image_logger(model, device, args.seed)
    del model, refine
    clock.mark("validate")
    t0 = time.perf_counter()
    bf16 = make_bf16_train_model(device, args.seed)
    torch.cuda.synchronize()
    log(f"[train_bf16] full-width model by fast_init on the card in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    phase_train_reference(bf16, device, args.seed)
    runs["train_bf16"] = phase_training(bf16, device, args.seed)
    bf16_refine = make_bf16_refine_model(bf16, device, args.seed)
    phase_train_reference(bf16_refine, device, args.seed)
    runs["refine_bf16"] = phase_training(bf16_refine, device, args.seed)
    runs["validate_bf16"] = phase_validate(bf16_refine, device, args.seed,
                                           "b, bf16 refine", want_bf16=True)
    clock.mark("bf16 training and validate")
    runs["ddp_nccl"] = phase_ddp_nccl(bf16, device, args.seed)
    del bf16, bf16_refine
    clock.mark("ddp_nccl")
    runs["ddp_gloo_2"] = phase_ddp_gloo(args.seed)
    clock.mark("ddp_gloo_2")
    runs["tp_gloo_2"], runs["tp_decode"] = phase_tp_gloo(args.seed, runs["serve"])
    clock.mark("tp_gloo_2 and tp_decode")
    phase_export(device, args.seed)
    clock.mark("export")
    log(f"[time] the tensor-parallel and export phases: "
        f"{clock.marks['tp_gloo_2 and tp_decode'] + clock.marks['export']:.1f} s")
    kernels = phase_kernels(device, runs)
    clock.mark("kernels")
    log(f"[time] seconds by phase {json.dumps(clock.marks)}; total "
        f"{sum(clock.marks.values()):.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
