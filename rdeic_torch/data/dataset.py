"""Training data (counterpart of rdeic_tpu/data/dataset.py): a file-list
image dataset and the loader assembly from the YAML tree, under torch's
DataLoader. PIL is imported inside the functions that read images."""
from __future__ import annotations

import random
import time
from pathlib import Path
from typing import Optional

import numpy as np
from torch.utils.data import DataLoader, Dataset, Sampler

from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.utils.image import augment, center_crop_arr, random_crop_arr


def load_file_list(path: str) -> list[str]:
    return [line.strip() for line in Path(path).read_text().splitlines()
            if line.strip()]


def list_image_files(folder: str) -> list[str]:
    """Every image file under `folder`, subdirectories included (png, jpg,
    jpeg, bmp, webp, in any case), in sorted path order."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
    return [str(p) for p in sorted(Path(folder).rglob("*"))
            if p.suffix.lower() in exts and p.is_file()]


class LICDataset(Dataset):
    """File-list images for learned-compression training: crop (none,
    center or random), flip/rotate, and {"jpg": [-1, 1] HWC float32,
    "txt": ""}. With `cache_size` > 0 the decoded RGB images are kept in a
    first-in first-out cache of that many entries (decoding can bound a
    step once the card is fast); 0 turns it off."""

    def __init__(self, file_list: str, out_size: int = 256,
                 crop_type: str = "random", use_hflip: bool = True,
                 use_rot: bool = False, seed: Optional[int] = None,
                 cache_size: int = 0):
        if crop_type not in ("none", "center", "random"):
            raise ValueError(f"crop_type {crop_type!r}")
        self.paths = load_file_list(file_list)
        self.out_size = out_size
        self.crop_type = crop_type
        self.use_hflip = use_hflip
        self.use_rot = use_rot
        self.rng = random.Random(seed)
        self.cache_size = int(cache_size)
        self._cache: dict = {}  # insertion order is the eviction order

    def __len__(self) -> int:
        return len(self.paths)

    def _load(self, path: str):
        """The decoded image, from the cache when it holds `path`."""
        if path in self._cache:
            return self._cache[path]
        img = self._load_uncached(path)
        if self.cache_size:
            if len(self._cache) >= self.cache_size:
                del self._cache[next(iter(self._cache))]
            self._cache[path] = img
        return img

    @staticmethod
    def _load_uncached(path: str):
        """The image as RGB, three tries a second apart (slow network disks)."""
        from PIL import Image  # noqa: PLC0415

        for attempt in range(3):
            try:
                with Image.open(path) as img:
                    return img.convert("RGB")
            except OSError:
                if attempt == 2:
                    raise
                time.sleep(1)
        raise AssertionError("unreachable")

    def __getitem__(self, idx: int) -> dict:
        pil = self._load(self.paths[idx])
        if self.crop_type == "center":
            arr = center_crop_arr(pil, self.out_size)
        elif self.crop_type == "random":
            arr = random_crop_arr(pil, self.out_size, rng=self.rng)
        else:
            arr = np.array(pil)
        arr = augment(arr, hflip=self.use_hflip, rotation=self.use_rot,
                      rng=self.rng)
        return dict(jpg=arr.astype(np.float32) / 127.5 - 1.0, txt="")


class EpochOrder(Sampler):
    """The indices of one pass over `n` items: in order, or shuffled by
    `random.Random(seed + epoch)`, `epoch` counting the passes from 0, the
    order of rdeic_tpu's DataLoader."""

    def __init__(self, n: int, shuffle: bool = True, seed: int = 0):
        self.n, self.shuffle, self.seed = n, shuffle, seed
        self.epoch = 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        idx = list(range(self.n))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        return iter(idx)


class DataModule:
    """The training loader from the data config tree. Validation is not
    ported yet (ROADMAP Queue 1, validation and callbacks): `val_config` is
    accepted and unused."""

    def __init__(self, train_config: Optional[str | dict] = None,
                 val_config: Optional[str | dict] = None):
        self.train_config = train_config
        self.val_config = val_config

    def train_dataloader(self) -> Optional[DataLoader]:
        """Batches {"jpg": [B, H, W, 3] float32 tensor, "txt": [str]} in the
        order of rdeic_tpu's loader (`EpochOrder` from `data_loader.seed`,
        default 0), read in the main process."""
        cfg = self.train_config
        if cfg is None:
            return None
        if isinstance(cfg, str):
            cfg = load_yaml(cfg)
        kw = dict(cfg.get("data_loader") or {})
        ds = instantiate_from_config(cfg["dataset"])
        return DataLoader(
            ds, batch_size=kw.get("batch_size", 1),
            sampler=EpochOrder(len(ds), kw.get("shuffle", True),
                               kw.get("seed", 0)),
            drop_last=kw.get("drop_last", True))
