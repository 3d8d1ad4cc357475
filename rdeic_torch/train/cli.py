"""Training CLI (counterpart of the root train.py):

    python -m rdeic_torch.train --config configs/train_rdeic.yaml \
        [--max_steps N] [--device cpu]

Reads the YAML tree (data, model, trainer), builds the loader and the model
(`model.overrides.is_refine: true` selects the refine phase), optionally
resumes (`model.resume`: a file that `Trainer.save` wrote, or a
flat `.npz` of JAX params as weights), then runs `Trainer.step` per
micro-batch. Logs JSONL metrics to `<out_dir>/metrics.jsonl` every
`log_every_n_steps` and writes the full train state to
`<out_dir>/checkpoints/step_<N>.pt` every `ckpt_every_n_steps` and at the
end. Runs on CUDA unless `--device cpu`. Validation and the image logger are
not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.train.trainer import Trainer
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.convert import load_npz_weights

# trainer settings of the JAX CLI that the port does not run yet, and the
# ROADMAP Queue 1 item that brings each
_NOT_PORTED = {"compute_dtype": "bf16", "frozen_dtype": "bf16",
               "fast_init": "training settings"}


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


def build_model(cfg: dict, device: torch.device):
    """The model of `cfg["model"]`, its YAML deep-updated by the optional
    `overrides`, and the `.npz` weights of `resume` when it names one."""
    model_cfg = load_yaml(cfg["model"]["config"])
    _deep_update(model_cfg.setdefault("params", {}),
                 cfg["model"].get("overrides") or {})
    if model_cfg["params"].get("sync_path"):
        raise NotImplementedError(
            "sync_path: converting an SD 2.1 torch checkpoint: ROADMAP "
            "Queue 1, training settings")
    model = instantiate_from_config(model_cfg, device=device)
    resume = cfg["model"].get("resume")
    if resume and str(resume).endswith(".npz"):
        kept = load_npz_weights(model, resume)
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
    for key, item in _NOT_PORTED.items():
        if tcfg.get(key):
            raise NotImplementedError(f"trainer.{key}: ROADMAP Queue 1, {item}")
    mesh = tcfg.get("mesh") or {}
    if (mesh.get("dp") or 1) > 1 or (mesh.get("tp") or 1) > 1:
        raise NotImplementedError("trainer.mesh: one device only; DDP is "
                                  "ROADMAP Queue 1, multi-device")
    device = resolve_device(args.device)
    seed = int(tcfg.get("seed", 231))
    torch.manual_seed(seed)
    model = build_model(cfg, device)
    phase = "refine" if model.is_refine else "independent"
    print(f"[rdeic_torch.train: {phase} phase; validation and the image "
          "logger are not ported yet (ROADMAP Queue 1, validation and "
          "callbacks)]", flush=True)
    trainer = Trainer(model, learning_rate=tcfg.get("learning_rate"),
                      accumulate_grad_batches=int(
                          tcfg.get("accumulate_grad_batches", 1)))
    resume = cfg["model"].get("resume")
    if resume and not str(resume).endswith(".npz"):
        trainer.load(resume)
        print(f"[resumed the train state at step {trainer.step_count}]")

    data = instantiate_from_config(cfg["data"])
    loader = data.train_dataloader(seed=seed)
    if len(loader) == 0:
        raise ValueError("the training set gives no full batch")
    out_dir = Path(tcfg.get("out_dir", "./runs/rdeic"))
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = out_dir / "metrics.jsonl"
    ckpt_dir = out_dir / "checkpoints"
    max_steps = args.max_steps or int(tcfg.get("max_steps", 100000))
    log_every = int(tcfg.get("log_every_n_steps", 50))
    ckpt_every = int(tcfg.get("ckpt_every_n_steps", 5000))
    generator = torch.Generator(device=device).manual_seed(seed)

    t0 = time.time()
    while trainer.step_count < max_steps:
        for batch in loader:
            logs = trainer.step(batch["jpg"].to(device), generator=generator)
            step = trainer.step_count
            if step % log_every == 0:
                logs["steps_per_sec"] = log_every / (time.time() - t0)
                t0 = time.time()
                log_metrics(metrics, step, logs)
                print(f"step {step}: " + ", ".join(
                    f"{k}={float(v):.4g}" for k, v in logs.items()), flush=True)
            if step % ckpt_every == 0:
                trainer.save(ckpt_dir / f"step_{step}.pt")
            if step >= max_steps:
                break
    trainer.save(ckpt_dir / f"step_{trainer.step_count}.pt")
    print("done")
    return 0
