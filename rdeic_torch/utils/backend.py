"""Device choice, and the scoped convolution / product numerics of the path."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Raises when CUDA is asked for and absent (no quiet CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_fp32(deterministic: bool = False) -> Iterator[None]:
    """Inside the block, cuDNN convolutions and matmuls run in full fp32:
    TF32 (which cuDNN convolutions use by default) keeps ~3 decimal digits.
    With `deterministic`, cuDNN also picks only deterministic algorithms, by
    heuristics rather than timing (`benchmark` off), so the same shapes run
    the same algorithms every time. The previous settings come back on exit.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
             matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    if deterministic:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         matmul.allow_tf32) = saved
