"""Build train.list / valid.list from image folders (counterpart of the root
make_file_list.py; the same shuffle, so the same lists).

    python -m rdeic_torch.make_file_list --img_folder a/ b/ \
        [--val_size 0] [--save_folder ./datalists] [--seed 231]
"""
from __future__ import annotations

import argparse
import random
from pathlib import Path

from rdeic_torch.data.dataset import list_image_files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--img_folder", type=str, required=True, nargs="+")
    ap.add_argument("--val_size", type=int, default=0)
    ap.add_argument("--save_folder", type=str, default="./datalists")
    ap.add_argument("--seed", type=int, default=231)
    args = ap.parse_args(argv)

    files = []
    for folder in args.img_folder:
        files.extend(str(Path(f).absolute()) for f in list_image_files(folder))
    random.Random(args.seed).shuffle(files)

    out = Path(args.save_folder)
    out.mkdir(parents=True, exist_ok=True)
    val = files[: args.val_size]
    train = files[args.val_size :]
    (out / "train.list").write_text("\n".join(train) + "\n")
    (out / "valid.list").write_text("\n".join(val) + "\n" if val else "")
    print(f"wrote {len(train)} train / {len(val)} valid entries to {out}")


if __name__ == "__main__":
    main()
