"""Builds the port's native code at first use, from the sources in the package.

Two shared libraries, each with a plain C interface loaded through ctypes:

- ``flash_attn_fwd``: ``csrc/flash_attn_fwd.cu``, compiled by ``nvcc`` for
  ``sm_90a`` (only where the CUDA toolkit is installed);
- ``rans``: ``entropy/csrc/rans.cpp``, the host rANS coder, compiled by g++.

Each library lands in ``_build/`` under a name that hashes its source, its
command and the compiler's version, so an edited source or another toolchain
rebuilds, and concurrent builds (test workers) never see a half-written file:
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


def _build(src: Path, stem: str, cmd: list[str]) -> Path:
    """Compile `src` with `cmd` (everything but the output and source) into
    a content-addressed shared library; return its path."""
    version = subprocess.run([cmd[0], "--version"], capture_output=True,
                             text=True, check=True).stdout
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(cmd).encode() + version.encode())
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


def build_flash() -> Path:
    """nvcc for sm_90a into a library with a plain C interface (no PyTorch
    headers, so it builds in seconds). `-Xptxas -v` keeps each kernel's
    registers and spills in the log."""
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    return _build(FLASH_SRC, "flash_attn_fwd", cmd)


def build_rans() -> Path:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
    return _build(RANS_SRC, "rans", cmd)


def build_all() -> dict[str, Path]:
    """Start every build at once and wait for all of them."""
    builds = {"flash_attn_fwd": build_flash, "rans": build_rans}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builds.items()}
        return {name: fut.result() for name, fut in futures.items()}


def build_log(lib: Path) -> str:
    """The compiler's output kept beside a library ('' if there is none)."""
    log = lib.with_suffix(".log")
    return log.read_text() if log.exists() else ""
