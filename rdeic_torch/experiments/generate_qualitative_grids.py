"""Qualitative comparison grids: reference vs reconstructions side by side
(counterpart of the root experiments/generate_qualitative_grids.py).

    python -m rdeic_torch.experiments.generate_qualitative_grids \
        --ref_dir refs/ --recon_dirs a/ b/ [--output grid.png] \
        [--max_images 6] [--thumb 256]

One row per common image stem (up to --max_images), the reference then
each reconstruction folder, each a thumbnail in a --thumb square cell.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rdeic_torch.data.dataset import list_image_files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref_dir", type=str, required=True)
    ap.add_argument("--recon_dirs", type=str, nargs="+", required=True,
                    help="one or more reconstruction folders (columns)")
    ap.add_argument("--labels", type=str, nargs="+", default=None,
                    help="accepted, unused (as in the root script)")
    ap.add_argument("--output", type=str, default="./qualitative_grid.png")
    ap.add_argument("--max_images", type=int, default=6)
    ap.add_argument("--thumb", type=int, default=256)
    args = ap.parse_args(argv)

    from PIL import Image  # noqa: PLC0415 (only the CLI reads images)

    refs = {Path(f).stem: f for f in list_image_files(args.ref_dir)}
    cols = [{Path(f).stem: f for f in list_image_files(d)} for d in args.recon_dirs]
    names = sorted(set(refs).intersection(*[set(c) for c in cols]))[: args.max_images]
    if not names:
        raise SystemExit("no common image stems")

    t = args.thumb
    ncol = 1 + len(cols)
    grid = Image.new("RGB", (ncol * t, len(names) * t), "white")
    for r, name in enumerate(names):
        for c, src in enumerate([refs[name]] + [col[name] for col in cols]):
            im = Image.open(src).convert("RGB")
            im.thumbnail((t, t))
            grid.paste(im, (c * t, r * t))
    grid.save(args.output)
    print(f"wrote {args.output} ({len(names)} rows x {ncol} cols)")


if __name__ == "__main__":
    main()
