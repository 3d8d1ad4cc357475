"""Training and validation data (counterpart of rdeic_tpu/data/dataset.py):
a file-list image dataset, a prefetching batch loader with the reference
loader's order and draws, the upload of batches one step ahead, and the
loaders' assembly from the YAML tree. PIL is imported inside the functions
that read images."""
from __future__ import annotations

import collections
import queue
import random
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch
from torch.utils.data import Dataset

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


class DataLoader:
    """Shuffling, prefetching batch iterator over a map-style dataset, with
    the semantics of rdeic_tpu's DataLoader: a pass visits the items in
    order, or in the order of `random.Random(seed + epoch)`; `epoch` rises
    when a pass starts; one worker thread per pass decodes its batches, in
    item order, into a queue of `prefetch` batches, so every draw a dataset
    makes from its own `rng` happens on the worker in item order. Batches
    are {"jpg": [B, H, W, 3] float32 tensor, "txt": [str]}."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 drop_last: bool = True, prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _start_pass(self) -> list[list[int]]:
        """The item indices of the next pass's batches; counts the pass."""
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        batches = [idx[i: i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _collate(self, indices: list[int]) -> dict:
        items = [self.dataset[i] for i in indices]
        return {"jpg": torch.from_numpy(np.stack([it["jpg"] for it in items])),
                "txt": [it["txt"] for it in items]}

    def first_batch(self) -> dict:
        """The batch the root train.py reads with `next(iter(loader))`
        before it trains, leaving the state its abandoned pass leaves once
        the pass's worker blocks: the epoch counted, and the draws of the
        pass's first min(batches, `prefetch` + 2) batches made (the one
        read, `prefetch` queued, one waiting on the full queue). Here the
        batches are decoded in order on the calling thread: no race."""
        batches = self._start_pass()
        if not batches:
            raise ValueError("the dataset gives no batch")
        ahead = batches if self.prefetch <= 0 else batches[: self.prefetch + 2]
        return [self._collate(b) for b in ahead][0]

    def __iter__(self) -> Iterator[dict]:
        batches = self._start_pass()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = threading.Event()  # the consumer left: the worker stops

        def put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in batches:
                    if not put(self._collate(b)):
                        return
                put(_END)
            except Exception as exc:  # raised again on the consumer's side
                put(_Failed(exc))

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while (item := q.get()) is not _END:
                if isinstance(item, _Failed):
                    raise item.exc
                yield item
        finally:  # a pass left early: its worker ends before another starts
            done.set()
            thread.join()


_END = object()


class _Failed:
    """A worker's exception, handed to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc


def device_prefetch(loader, device: torch.device, rows: slice = slice(None)
                    ) -> Iterator[tuple[torch.Tensor, dict]]:
    """(images on `device`, host batch) pairs of `loader`, each upload
    started one batch before the consumer takes it (rdeic_tpu's
    `device_prefetch` at its default depth of 2): on CUDA a pinned-memory,
    non-blocking copy, so the copy of batch k + 1 overlaps step k. Only the
    batch's `rows` go up (a data-parallel rank's, `Mesh.rows`); the whole
    host batch is kept for the image logger."""
    def upload(batch: dict) -> torch.Tensor:
        img = batch["jpg"][rows]
        if device.type == "cuda":
            return img.pin_memory().to(device, non_blocking=True)
        return img.to(device)

    it = iter(loader)
    buf: collections.deque = collections.deque()
    for host in it:
        buf.append((upload(host), host))
        if len(buf) == 2:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class DataModule:
    """The training and validation loaders from the data config tree."""

    def __init__(self, train_config: Optional[str | dict] = None,
                 val_config: Optional[str | dict] = None):
        self.train_config = train_config
        self.val_config = val_config

    @staticmethod
    def _build(cfg) -> tuple:
        """(dataset, `data_loader` keyword arguments) of a config, without
        the torch DataLoader settings no thread loader takes."""
        if cfg is None:
            return None, {}
        if isinstance(cfg, str):
            cfg = load_yaml(cfg)
        kw = dict(cfg.get("data_loader") or {})
        kw.pop("num_workers", None)
        kw.pop("pin_memory", None)
        return instantiate_from_config(cfg["dataset"]), kw

    def train_dataloader(self) -> Optional[DataLoader]:
        """The training batches in the order of rdeic_tpu's loader
        (`data_loader.seed`, default 0)."""
        ds, kw = self._build(self.train_config)
        return None if ds is None else DataLoader(ds, **kw)

    def val_dataloader(self) -> Optional[DataLoader]:
        """The validation batches in file-list order (never shuffled);
        batch size and `drop_last` from the config."""
        ds, kw = self._build(self.val_config)
        if ds is None:
            return None
        kw.pop("shuffle", None)
        return DataLoader(ds, shuffle=False, **kw)
