"""Convert PyTorch checkpoints (SD 2.1 base + compression-and-control) into
the flat `.npz` params file that every CLI of the port and of the JAX
package reads (counterpart of the root convert_checkpoint.py).

    python -m rdeic_torch.convert_checkpoint --config configs/model/rdeic.yaml \
        --sd_ckpt v2-1_512-ema-pruned.ckpt --cc_ckpt rdeic_ckpt.ckpt \
        --out params.npz [--sync_control] [--lpips_ckpt alex.pth] \
        [--device cpu]

The template is the model of `--config` with a CLIP text tower and
LPIPS(alex), every tensor made from `--seed` by `utils.fast_init`'s rule
(the root CLI's template is flax's initialisation from the same seed, so
the leaves that no checkpoint fills differ between the two files). The SD
dict is read first and the CC dict updates it; every leaf that
`utils.torch_convert` maps is converted (`--sync_control`: control-module
leaves that both lack take the base UNet's, tiled and truncated); the
LPIPS heads come from `lin{i}.model.1.weight` or `lins.{i}.model.1.weight`;
`uncond_context` is the converted CLIP tower's context of the empty prompt.
The file is written by `utils.checkpoint_io.save_params_npz`.
`--image_size` is the root CLI's flag: the port's template has the same
shapes at any image size. Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse

import torch

from rdeic_torch.models.clip import tokenize_empty
from rdeic_torch.models.lpips import LPIPS
from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.utils.backend import resolve_device
from rdeic_torch.utils.checkpoint_io import save_params_npz
from rdeic_torch.utils.fast_init import fast_random_init
from rdeic_torch.utils.torch_convert import convert_state_dict, load_torch_checkpoint


def template(config: str, device: torch.device, seed: int):
    """The model of `config` with CLIP and LPIPS, made on `device` from
    `seed` (`fast_random_init`)."""
    model = instantiate_from_config(load_yaml(config), device="meta")
    model.attach_clip()
    if not hasattr(model, "lpips"):
        with torch.device("meta"):
            model.lpips = LPIPS("alex")
    return fast_random_init(model, device, seed=seed)


@torch.no_grad()
def copy_lpips_heads(model, lpips_ckpt: str) -> int:
    """The LPIPS linear heads of an `alex.pth` (`lin{i}.model.1.weight`, or
    the lpips package's `lins.{i}.model.1.weight`); how many were found."""
    lp = torch.load(lpips_ckpt, map_location="cpu", weights_only=True)
    found = 0
    for i in range(5):
        key = next((k for k in (f"lin{i}.model.1.weight",
                                f"lins.{i}.model.1.weight") if k in lp), None)
        if key is not None:
            getattr(model.lpips, f"lin{i}").weight.copy_(lp[key].float())
            found += 1
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=str, default="configs/model/rdeic.yaml")
    ap.add_argument("--sd_ckpt", type=str, default=None,
                    help="SD 2.1 base checkpoint (v2-1_512-ema-pruned.ckpt)")
    ap.add_argument("--cc_ckpt", type=str, default=None,
                    help="compression-and-control checkpoint")
    ap.add_argument("--lpips_ckpt", type=str, default=None,
                    help="lpips lin-layer weights (alex.pth)")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--sync_control", action="store_true",
                    help="initialise control weights from the base UNet "
                         "(tile/truncate) when absent from the checkpoints")
    ap.add_argument("--image_size", type=int, default=512,
                    help="accepted as the root CLI's; shapes do not depend on it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print("building the params template (random init)...")
    model = template(args.config, device, args.seed)
    merged = {}  # the SD dict first, the CC dict updates it
    for path in (args.sd_ckpt, args.cc_ckpt):
        if path:
            print(f"loading {path}...")
            merged.update(load_torch_checkpoint(path))
    if not merged:
        raise SystemExit("provide at least one of --sd_ckpt / --cc_ckpt")
    state, missing = convert_state_dict(merged, model,
                                        sync_control=args.sync_control)
    model.load_state_dict(state, strict=False)
    print(f"[{len(missing)} leaves kept random "
          f"(hint processing / cross connections included)]")
    for m in missing[:20]:
        print("  missing:", m)
    if args.lpips_ckpt:
        copy_lpips_heads(model, args.lpips_ckpt)
        print("lpips lin weights converted")
    print("computing empty-prompt CLIP embedding...")
    tokens = torch.from_numpy(tokenize_empty(1))
    with torch.no_grad():
        model.uncond_context.copy_(model.get_learned_conditioning(tokens=tokens))
    save_params_npz(args.out, model)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
