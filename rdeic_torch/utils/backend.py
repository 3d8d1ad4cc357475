"""Device choice, and the scoped convolution / product numerics of the path."""
from __future__ import annotations

import contextlib
import threading

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


# The flags are process-wide, not per thread: the scopes open in all threads
# are counted, the flags are set while any is open, and the settings from
# before the first come back only when the last closes.
_LOCK = threading.Lock()
_OPEN = {"fp32": 0, "deterministic": 0}
_SAVED: list = []


def _flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            matmul.allow_tf32)


def _set_flags(allow_tf32, deterministic, benchmark, matmul_tf32) -> None:
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = (
        allow_tf32, deterministic, benchmark)
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


class full_fp32(contextlib.ContextDecorator):
    """Inside the block, cuDNN convolutions and matmuls run in full fp32:
    TF32 (which cuDNN convolutions use by default) keeps ~3 decimal digits.
    With `deterministic`, cuDNN also picks only deterministic algorithms, by
    heuristics rather than timing (`benchmark` off), so the same shapes run
    the same algorithms every time.

    The flags belong to the process, so the scope is counted across threads
    (a sampler in one thread and the codec in another, as the batched
    serving CLI runs them): TF32 stays off while any scope is open, and the
    deterministic choice while any deterministic one is; the settings from
    before the first scope come back when the last one closes. A block that
    closes in one thread never turns TF32 back on under another's."""

    def __init__(self, deterministic: bool = False):
        self.deterministic = deterministic

    def __enter__(self):
        with _LOCK:
            if _OPEN["fp32"] == 0:
                _SAVED[:] = _flags()
            _OPEN["fp32"] += 1
            _OPEN["deterministic"] += self.deterministic
            self._apply()
        return self

    def __exit__(self, *exc) -> None:
        with _LOCK:
            _OPEN["fp32"] -= 1
            _OPEN["deterministic"] -= self.deterministic
            if _OPEN["fp32"] == 0:
                _set_flags(*_SAVED)
            else:
                self._apply()

    @staticmethod
    def _apply() -> None:
        """The flags that the open scopes ask for (called under the lock)."""
        allow_tf32, deterministic, benchmark, _ = _SAVED
        if _OPEN["deterministic"]:
            deterministic, benchmark = True, False
        _set_flags(False, deterministic, benchmark, False)
