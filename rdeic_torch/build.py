"""Builds the port's native code at first use, from the sources in the package.

Seven shared libraries, each with a plain C interface loaded through ctypes:

- ``flash_attn_fwd`` and ``flash_attn_bwd``: ``csrc/flash_attn_{fwd,bwd}.cu``
  (with ``csrc/flash_common.cuh``, ``csrc/flash_mma.cuh``,
  ``csrc/flash_bf16.cuh`` and ``csrc/flash_hopper.cuh``), compiled by
  ``nvcc`` for ``sm_90a``
  (only where the CUDA toolkit is installed);
- ``wgmma_probe``: ``csrc/wgmma_probe.cu``, one warpgroup product that
  reads how ``wgmma`` rounds (``tools/wgmma_probe.py``), likewise;
- ``group_norm_fwd`` and ``group_norm_bwd``: ``csrc/group_norm_{fwd,bwd}.cu``
  (with ``csrc/group_norm_common.cuh``), the cluster-launched GroupNorm(+SiLU)
  forward and backward, by ``nvcc`` for ``sm_90a`` likewise;
- ``device_rans``: ``csrc/device_rans.cu``, the interleaved-lane rANS decode
  (per-lane and shared-stream) and encode kernels, by ``nvcc`` for
  ``sm_90a`` likewise;
- ``rans``: ``entropy/csrc/rans.cpp``, the host rANS coder, compiled by g++.

Each library lands in ``_build/`` under a name that hashes its source, the
headers it includes, its command and the compiler's version, so an edited
source or another toolchain rebuilds, and concurrent builds (test workers) never see a half-written file:
the compiler writes a private temporary name that is renamed into place.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE / "_build"
FLASH_SRC = PACKAGE / "csrc" / "flash_attn_fwd.cu"
FLASH_BWD_SRC = PACKAGE / "csrc" / "flash_attn_bwd.cu"
FLASH_HEADERS = (PACKAGE / "csrc" / "flash_common.cuh",
                 PACKAGE / "csrc" / "flash_mma.cuh",
                 PACKAGE / "csrc" / "flash_bf16.cuh",
                 PACKAGE / "csrc" / "flash_hopper.cuh")
WGMMA_PROBE_SRC = PACKAGE / "csrc" / "wgmma_probe.cu"
GROUP_NORM_SRC = PACKAGE / "csrc" / "group_norm_fwd.cu"
GROUP_NORM_BWD_SRC = PACKAGE / "csrc" / "group_norm_bwd.cu"
GROUP_NORM_HEADERS = (PACKAGE / "csrc" / "group_norm_common.cuh",)
DEVICE_RANS_SRC = PACKAGE / "csrc" / "device_rans.cu"
RANS_SRC = PACKAGE / "entropy" / "csrc" / "rans.cpp"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _build(src: Path, stem: str, cmd: list[str],
           headers: tuple[Path, ...] = ()) -> Path:
    """Compile `src` (which includes `headers`) with `cmd` (everything but
    the output and source) into a content-addressed shared library; return
    its path."""
    version = subprocess.run([cmd[0], "--version"], capture_output=True,
                             text=True, check=True).stdout
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in (src, *headers))
        + " ".join(cmd).encode() + version.encode())
    out = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(cmd + ["-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed ({' '.join(cmd)}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _nvcc_cmd() -> list[str]:
    """nvcc for sm_90a into a library with a plain C interface (no PyTorch
    headers, so it builds in seconds). `-Xptxas -v` keeps each kernel's
    registers and spills in the log."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_flash() -> Path:
    return _build(FLASH_SRC, "flash_attn_fwd", _nvcc_cmd(), FLASH_HEADERS)


def build_flash_bwd() -> Path:
    return _build(FLASH_BWD_SRC, "flash_attn_bwd", _nvcc_cmd(), FLASH_HEADERS)


def build_wgmma_probe() -> Path:
    return _build(WGMMA_PROBE_SRC, "wgmma_probe", _nvcc_cmd(), FLASH_HEADERS)


def build_group_norm() -> Path:
    return _build(GROUP_NORM_SRC, "group_norm_fwd", _nvcc_cmd(),
                  GROUP_NORM_HEADERS)


def build_group_norm_bwd() -> Path:
    return _build(GROUP_NORM_BWD_SRC, "group_norm_bwd", _nvcc_cmd(),
                  GROUP_NORM_HEADERS)


def build_device_rans() -> Path:
    return _build(DEVICE_RANS_SRC, "device_rans", _nvcc_cmd())


def build_rans() -> Path:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
    return _build(RANS_SRC, "rans", cmd)


def build_all() -> dict[str, Path]:
    """Start every build at once and wait for all of them."""
    builds = {"flash_attn_fwd": build_flash, "flash_attn_bwd": build_flash_bwd,
              "group_norm_fwd": build_group_norm,
              "group_norm_bwd": build_group_norm_bwd,
              "device_rans": build_device_rans, "rans": build_rans,
              "wgmma_probe": build_wgmma_probe}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builds.items()}
        return {name: fut.result() for name, fut in futures.items()}


def build_log(lib: Path) -> str:
    """The compiler's output kept beside a library ('' if there is none)."""
    log = lib.with_suffix(".log")
    return log.read_text() if log.exists() else ""
