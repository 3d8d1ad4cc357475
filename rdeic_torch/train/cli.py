"""Training CLI (counterpart of the root train.py):

    python -m rdeic_torch.train --config configs/train_rdeic.yaml \
        [--max_steps N] [--device cpu]
    torchrun --nproc_per_node N -m rdeic_torch.train --config ...

Reads the YAML tree (data, model, trainer), builds the loader and the model
(`model.overrides.is_refine: true` selects the refine phase), optionally
resumes (`model.resume`: a file that `Trainer.save` wrote, a directory of
them whose latest step loads, or a flat `.npz` of JAX params as weights; a
directory that is absent or holds no step starts fresh, as the root
train.py does), then runs `Trainer.step` per micro-batch, the batches in
the order of the root train.py's: it reads one batch first, as train.py
reads the image size, and trains from the loader's second pass
(`data_loader.seed`; `trainer.seed` seeds the model and the noise). A
worker thread decodes the batches and each is uploaded one step ahead.
Logs JSONL metrics to `<out_dir>/metrics.jsonl` every `log_every_n_steps`
and writes the full train state to `<out_dir>/checkpoints/step_<N>.pt`
every `ckpt_every_n_steps`, keeping the `ckpt_keep` newest (-1: all), and
at the end, pruning nothing. Every `image_log_every_n_steps` the image
logger writes `<out_dir>/image_log/step_<N>/`; every `val_check_interval`
steps (0: never) up to 8 batches of the data config's `val_config` are
validated, their averages logged at that step and printed as
`validation @ N: {...}`. Both draw their noise from a generator seeded
with the step, never from the training noise. Runs on CUDA unless
`--device cpu`.

Several devices (train.py's `trainer.mesh: {dp, tp}`; dp ~ takes them
all): one process a device, launched by torchrun, whose environment
starts torch.distributed (NCCL on CUDA, each rank on cuda:LOCAL_RANK; gloo
with `--device cpu`). Every rank builds the same model and loader (an
unseeded dataset takes rank 0's crop stream: `share_data_stream`), reads
the global batch (`data_loader.batch_size`, which dp must divide) and
uploads the rows of its dp index; the trainer averages the gradients over
the ranks (train/trainer.py). At tp above 1 the model's kernels are
placed by `shard_params` (each rank holds its tp block of every sharded
kernel), and every rank joins a checkpoint's gather. Rank 0 alone writes
`metrics.jsonl`, the checkpoints (and prunes them) and the image logs, and
validates, while the others wait at a barrier; at tp above 1 the other
ranks of its tp group compute the image logs and validation beside it,
since its layers need theirs. Every rank loads `resume`. Plain `python -m
rdeic_torch.train` is a world of one, where a mesh above one device is
refused (`ValueError`, as train.py's `make_mesh`).

The trainer settings of the repo's bf16 recipes, in train.py's order:
`compute_dtype` (the denoiser and the VAE compute in it, the weights stay
fp32), `frozen_dtype` (the frozen tensors are stored in it) and
`fast_init` (the model is built on `meta` and filled from `trainer.seed`
by the JAX package's `fast_random_params` rule; a `resume` then overlays
its weights). The model's `sync_path` (an SD 2.1 torch checkpoint) is
converted into it, with `synch_control`, when the file exists and no
`resume` is set, as train.py does.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from rdeic_torch.data.dataset import device_prefetch
from rdeic_torch.parallel.mesh import (init_distributed, local_rank, make_mesh,
                                       shard_params)
from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.train.callbacks import ImageLogger
from rdeic_torch.train.trainer import Trainer, cast_frozen, prune_checkpoints
from rdeic_torch.train.validation import run_validation
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.convert import load_npz_weights
from rdeic_torch.utils.fast_init import fast_random_init
from rdeic_torch.utils.torch_convert import convert_state_dict, load_torch_checkpoint


def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def log_metrics(path: Path, step: int, logs: dict) -> None:
    row = {"step": step, **{k: float(v) for k, v in logs.items()}}
    with path.open("a") as f:
        f.write(json.dumps(row) + "\n")


def torch_dtype(name: str) -> torch.dtype:
    """A YAML dtype name ("bfloat16", "float32") as a torch float dtype."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"{name!r} is not a float dtype")
    return dtype


def sync_base_weights(model, sync_path: str, synch_control: bool) -> None:
    """Copy the tensors that the SD 2.1 checkpoint `sync_path` holds into
    `model`, each into its parameter (its own dtype and device); with
    `synch_control` the control module takes the base UNet's weights where
    the checkpoint has none of its own."""
    state, missing = convert_state_dict(load_torch_checkpoint(sync_path),
                                        model, sync_control=synch_control)
    with torch.no_grad():
        model.load_state_dict(state, strict=False)
    print(f"[synced base weights from {sync_path}; "
          f"{len(missing)} keys stay random]")


def share_data_stream(loader) -> None:
    """Give every rank rank 0's state of the dataset's `random` stream
    (crops and flips), so that all ranks read the same global batches. A
    dataset without a `seed` seeds its stream from the OS's entropy, which
    differs between processes."""
    rng = getattr(loader.dataset, "rng", None)
    if rng is None:
        return
    state = [rng.getstate()]
    dist.broadcast_object_list(state, src=0)
    rng.setstate(state[0])


def build_model(cfg: dict, device: torch.device):
    """The model of `cfg["model"]`, its YAML deep-updated by the optional
    `overrides`, with the trainer's `compute_dtype`, its frozen tensors in
    `frozen_dtype`, made by `fast_init` from `trainer.seed` when asked, the
    SD 2.1 weights of `sync_path` when that file exists and no `resume` is
    set (train.py's rule), and the `.npz` weights of `resume` when it names
    one."""
    tcfg = cfg.get("trainer", {})
    model_cfg = load_yaml(cfg["model"]["config"])
    _deep_update(model_cfg.setdefault("params", {}),
                 cfg["model"].get("overrides") or {})
    fast = bool(tcfg.get("fast_init"))
    model = instantiate_from_config(model_cfg,
                                    device="meta" if fast else device)
    if tcfg.get("compute_dtype"):
        model.set_compute_dtype(torch_dtype(tcfg["compute_dtype"]),
                                cast_weights=False)
        print(f"[compute dtype: {tcfg['compute_dtype']}]")
    if tcfg.get("frozen_dtype"):  # the trainer's cast; on meta, before
        # fast_init, the frozen tensors are made in it
        cast_frozen(model, torch_dtype(tcfg["frozen_dtype"]))
    if fast:
        fast_random_init(model, device, seed=int(tcfg.get("seed", 231)))
    resume = cfg["model"].get("resume")
    sync_path = model_cfg["params"].get("sync_path")
    if sync_path and Path(sync_path).exists() and not resume:
        sync_base_weights(model, sync_path,
                          bool(model_cfg["params"].get("synch_control")))
    if resume and str(resume).endswith(".npz"):
        kept = load_npz_weights(model, resume, with_clip=False)
        if kept:
            print(f"[warm start from {resume}; fresh subtrees kept: {kept}]")
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = load_yaml(args.config)
    tcfg = cfg.get("trainer", {})
    device = resolve_device(args.device)
    world = init_distributed(device=device)
    if world and device.type == "cuda":
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    mesh_cfg = tcfg.get("mesh") or {}
    mesh = make_mesh(dp=mesh_cfg.get("dp"), tp=int(mesh_cfg.get("tp") or 1),
                     devices=None if world else [device])
    lead = mesh.rank in (None, 0)  # the rank that writes files
    seed = int(tcfg.get("seed", 231))
    torch.manual_seed(seed)
    model = build_model(cfg, device)
    phase = "refine" if model.is_refine else "independent"
    if lead:
        print(f"[rdeic_torch.train: {phase} phase; mesh {mesh.shape}]",
              flush=True)
    # build_model cast the frozen tensors on `meta` already (no fp32 copy
    # of the model), so the trainer's cast finds them in `frozen_dtype`
    shard_params(model, mesh)  # at tp = 1 nothing changes
    # rank 0's tp group computes what rank 0 logs and validates
    evaluates = lead or (mesh.shape["tp"] > 1 and mesh.dp_index == 0)
    frozen = tcfg.get("frozen_dtype")
    trainer = Trainer(model, learning_rate=tcfg.get("learning_rate"),
                      accumulate_grad_batches=int(
                          tcfg.get("accumulate_grad_batches", 1)),
                      frozen_dtype=torch_dtype(frozen) if frozen else None,
                      mesh=mesh if world else None)
    resume = cfg["model"].get("resume")
    if resume and not str(resume).endswith(".npz"):
        path = Path(resume)
        if not path.exists() or path.is_dir() and not any(path.glob("step_*")):
            print(f"[no checkpoint under {resume}: training starts fresh]")
        else:
            trainer.load(resume)
            print(f"[resumed the train state at step {trainer.step_count}]")

    data = instantiate_from_config(cfg["data"])
    loader = data.train_dataloader()
    if len(loader) == 0:
        raise ValueError("the training set gives no full batch")
    rows = mesh.rows(loader.batch_size)  # raises unless dp divides it
    if world:
        share_data_stream(loader)
    # train.py reads a batch for the image size, then trains from a new
    # pass: the same state here, without its thread race
    loader.first_batch()
    val_loader = data.val_dataloader()
    out_dir = Path(tcfg.get("out_dir", "./runs/rdeic"))
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)
    metrics = out_dir / "metrics.jsonl"
    ckpt_dir = out_dir / "checkpoints"
    max_steps = args.max_steps or int(tcfg.get("max_steps", 100000))
    log_every = int(tcfg.get("log_every_n_steps", 50))
    ckpt_every = int(tcfg.get("ckpt_every_n_steps", 5000))
    keep = int(tcfg.get("ckpt_keep", -1))
    val_every = int(tcfg.get("val_check_interval", 0))
    image_logger = ImageLogger(
        out_dir, every_n_steps=int(tcfg.get("image_log_every_n_steps", 2000)))
    generator = torch.Generator(device=device).manual_seed(seed)

    def step_generator(step: int) -> torch.Generator:
        """The noise of the step's image log and validation (train.py's
        PRNGKey(step)), apart from the training noise."""
        return torch.Generator(device=device).manual_seed(step)

    def save(prune: bool) -> None:
        """Every rank joins the gather of the tp blocks, rank 0 writes and
        prunes; the others wait."""
        trainer.save(ckpt_dir / f"step_{trainer.step_count}.pt")
        if lead and prune:
            prune_checkpoints(ckpt_dir, keep)
        mesh.barrier()

    t0 = time.time()
    while trainer.step_count < max_steps:
        for img, batch in device_prefetch(loader, device, rows):
            logs = trainer.step(img, generator=generator)
            step = trainer.step_count
            if step % log_every == 0 and lead:
                logs["steps_per_sec"] = log_every / (time.time() - t0)
                t0 = time.time()
                log_metrics(metrics, step, logs)
                print(f"step {step}: " + ", ".join(
                    f"{k}={float(v):.4g}" for k, v in logs.items()), flush=True)
            if step % ckpt_every == 0:
                save(prune=True)
            if evaluates:
                try:
                    image_logger.maybe_log(model, batch["jpg"], step,
                                           generator=step_generator(step),
                                           write=lead)
                except Exception:  # logging must never kill training
                    print(f"[image log at step {step} failed:]", flush=True)
                    traceback.print_exc()
            if val_every and val_loader is not None and step % val_every == 0:
                if evaluates:
                    vm = run_validation(model, val_loader, max_batches=8,
                                        generator=step_generator(step))
                if lead:
                    log_metrics(metrics, step, vm)
                    print(f"validation @ {step}: {vm}", flush=True)
                mesh.barrier()
            if step >= max_steps:
                break
    save(prune=False)  # as train.py's last save: nothing pruned
    if world:
        dist.destroy_process_group()
    if lead:
        print("done")
    return 0
