"""Process groups for the port's multi-device tests: spawn `world` Python
processes with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT on a free local port), each on one torch thread,
and wait for them (a test starts them, does its JAX work meanwhile, then
waits). The workers of this file run as

    python tests/torch_port_dist.py <worker> <workdir>

and import rdeic_torch alone (no JAX): they read `<workdir>/inputs.pt`, which
the test wrote, and write `<workdir>/rank<R>.pt`."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago (bound to 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for `rank`, one torch thread, the repo on the
    path."""
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return env


class Ranks:
    """`world` processes running `python argv`, started together: `wait`
    collects their standard outputs."""

    def __init__(self, argv: list[str], world: int, env: dict | None = None):
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, text=True,
            env={**rank_env(r, world, port), **(env or {})},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]

    def wait(self, timeout: float = 240) -> list[str]:
        """Every rank's output. Raises with them all when one fails or the
        time runs out (the others are killed then)."""
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        codes = [p.returncode for p in self.procs]
        if len(outs) < len(self.procs) or any(codes):
            raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(
                f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
        return outs


class Workers(Ranks):
    """`worker` of this file in `world` ranks on `workdir`, started now;
    `results` waits and loads each rank's outputs."""

    def __init__(self, worker: str, workdir: Path, world: int = 2):
        super().__init__([__file__, worker, str(workdir)], world)
        self.workdir, self.world = Path(workdir), world

    def results(self, timeout: float = 240) -> list[dict]:
        import torch  # noqa: PLC0415

        self.wait(timeout)
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


# -- the workers -----------------------------------------------------------------
def all_reduce_worker(workdir: Path) -> dict:
    """`init_distributed` with an explicit coordinator (gloo), then a sum
    of rank + 1 over the world."""
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    from rdeic_torch.parallel.mesh import init_distributed  # noqa: PLC0415

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    coordinator = f"127.0.0.1:{os.environ['MASTER_PORT']}"
    assert init_distributed(coordinator, world, rank, device="cpu")
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    out = {"sum": float(x), "backend": dist.get_backend()}
    dist.destroy_process_group()
    return out


def train_worker(workdir: Path) -> dict:
    """`Trainer` steps on this rank's rows: the model config and weights,
    the global batches and their noise, the accumulation, the learning
    rate and the mesh's (dp, tp) come from inputs.pt. Returns each step's
    rows, logs, codebook and usage, then the trainable weights, AdamW's
    first moment and the state dict."""
    import torch  # noqa: PLC0415

    from rdeic_torch.parallel.mesh import init_distributed, make_mesh  # noqa
    from rdeic_torch.pipeline.rdeic import RDEIC  # noqa: PLC0415
    from rdeic_torch.train.trainer import Trainer  # noqa: PLC0415

    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    assert init_distributed(device="cpu")
    mesh = make_mesh(dp=inp["dp"], tp=inp["tp"])
    model = RDEIC(**inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    trainer = Trainer(model, learning_rate=inp["lr"],
                      accumulate_grad_batches=inp["accumulate"], mesh=mesh)
    out = {"logs": [], "codebook": [], "prob": [], "rows": []}
    for img, noise in zip(inp["imgs"], inp["noise"]):
        rows = mesh.rows(img.shape[0])
        logs = trainer.step(img[rows], noise=noise)
        out["rows"].append((rows.start, rows.stop))
        out["logs"].append({k: v.clone() for k, v in logs.items()})
        out["codebook"].append(
            model.compression.quantize.embedding.detach().clone())
        out["prob"].append(model.vq_embed_prob.clone())
    out["params"] = {k: p.detach().clone() for k, p in trainer.params.items()}
    out["exp_avg"] = {k: trainer.optimizer.state[p]["exp_avg"].clone()
                      for k, p in trainer.params.items()
                      if "exp_avg" in trainer.optimizer.state.get(p, {})}
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    torch.distributed.destroy_process_group()
    return out


def loader_worker(workdir: Path) -> dict:
    """The training CLI's loader of inputs.pt's file list, unseeded, after
    `share_data_stream`: its first two batches (the crops and flips)."""
    import torch  # noqa: PLC0415

    from rdeic_torch.data.dataset import DataLoader, LICDataset  # noqa
    from rdeic_torch.parallel.mesh import init_distributed  # noqa: PLC0415
    from rdeic_torch.train.cli import share_data_stream  # noqa: PLC0415

    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    assert init_distributed(device="cpu")
    loader = DataLoader(LICDataset(inp["file_list"], out_size=48,
                                   use_rot=True), batch_size=2)
    share_data_stream(loader)
    batches = [b["jpg"] for b, _ in zip(loader, range(2))]
    torch.distributed.destroy_process_group()
    return {"batches": batches}


def dist_rank() -> int:
    return int(os.environ["RANK"])


def tp_worker(workdir: Path) -> dict:
    """The model of inputs.pt after `shard_params` on a (dp, tp) mesh.
    With `decode` (c_latent, guide_hint, steps and the global batch's
    `sample_noise`): this rank's rows decoded. With `img01`: that image
    coded to a stream file and decoded back. With `imgs`: `Trainer` steps
    on this rank's rows (as `train_worker`), then `Trainer.save` of the
    gathered state to <workdir>/ckpt.pt (every rank calls it, rank 0
    writes); with `resume`, a fresh sharded trainer loads that whole-tensor
    file. Returns this rank's tensors: the sharded weights' blocks, the
    logs, the trainable tensors after the steps and after the resume."""
    import torch  # noqa: PLC0415

    from rdeic_torch.parallel.mesh import (init_distributed, make_mesh,  # noqa
                                           params_shardings, shard_params)
    from rdeic_torch.pipeline.rdeic import RDEIC, noise_rows  # noqa: PLC0415
    from rdeic_torch.train.trainer import Trainer  # noqa: PLC0415

    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    assert init_distributed(device="cpu")
    mesh = make_mesh(dp=inp["dp"], tp=inp["tp"])

    def sharded_model():
        model = RDEIC(**inp["config"], device="cpu")
        model.load_state_dict(inp["state"], strict=True)
        return shard_params(model, mesh)

    model = sharded_model()
    out = {"blocks": {k: (s.block().start, s.block().stop)
                      for k, s in params_shardings(model, mesh).items()
                      if s.sharded},
           "weights": {k: p.detach().clone()
                       for k, p in model.named_parameters()}}
    if "decode" in inp:
        d = inp["decode"]
        rows = mesh.rows(d["c_latent"].shape[0])
        out["decode"] = model.decode_pipeline(
            d["c_latent"][rows], d["guide_hint"][rows], d["steps"],
            **noise_rows(d["noise"], rows))
    if "img01" in inp:  # the codec under the sharded weights
        img = inp["img01"]
        path = Path(workdir) / f"rank{dist_rank()}.rdeic"
        model.apply_condition_compress(img, path, *img.shape[1:3])
        out["stream"] = path.read_bytes()
        out["latents"] = model.apply_condition_decompress(path)
    if "imgs" in inp:
        trainer = Trainer(model, learning_rate=inp["lr"],
                          accumulate_grad_batches=inp["accumulate"], mesh=mesh)
        out["logs"], out["rows"] = [], []
        for img, noise in zip(inp["imgs"], inp["noise"]):
            rows = mesh.rows(img.shape[0])
            logs = trainer.step(img[rows], noise=noise)
            out["rows"].append((rows.start, rows.stop))
            out["logs"].append({k: v.clone() for k, v in logs.items()})
        out["params"] = {k: p.detach().clone()
                         for k, p in trainer.params.items()}
        trainer.save(Path(workdir) / "ckpt.pt")
    if "resume" in inp:
        trainer = Trainer(sharded_model(), learning_rate=inp["lr"],
                          accumulate_grad_batches=inp["accumulate"], mesh=mesh)
        trainer.load(inp["resume"])
        out["resumed"] = {k: p.detach().clone()
                          for k, p in trainer.params.items()}
        out["resumed_exp_avg"] = {
            k: trainer.optimizer.state[p]["exp_avg"].clone()
            for k, p in trainer.params.items()
            if "exp_avg" in trainer.optimizer.state.get(p, {})}
        out["resumed_step"] = trainer.step_count
    torch.distributed.destroy_process_group()
    return out


WORKERS = {"all_reduce": all_reduce_worker, "train": train_worker,
           "loader": loader_worker, "tp": tp_worker}

if __name__ == "__main__":
    import torch

    name, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    result = WORKERS[name](workdir)
    torch.save(result, workdir / f"rank{os.environ['RANK']}.pt")
