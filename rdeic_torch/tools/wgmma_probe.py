"""How the card's warpgroup product (wgmma) rounds, read from its results.

    python -m rdeic_torch.tools.wgmma_probe

Builds `csrc/wgmma_probe.cu` and runs D = C + A B through the instruction
forms of the d = 64 flash forward: bf16 m64n64k16 (A from registers, B
MN-major) and tf32 m64n64k8 (A from registers, B K-major). Each row of A
is one case whose exact sum lies between two fp32 values (B is all ones, so
D[r][0] is C[r][0] plus row r of A); `rounding()` reads which value comes
back. Prints the card's name and power limit, then one JSON object: per
type, the rounding of a sum (`sum`: "rz" toward zero or "rn" to nearest,
from 1 + 0.75 ulp and its negative), of a tie (`tie`: "rz", "rne" or
"rna"), of C + A B (`accumulate`), how far below the largest product's ulp
a small product still counts (`window`: the e of the first 1 - 2^-e ulp
that reads 1, or null), the sum of many small products (`small`: k - 1
products of 2^-e ulp beside a 1, in ulps), a random product's error
against float64 (which also checks the fragment layouts), and for tf32
how an fp32 operand is read (`operand_a`, `operand_b`: "truncate" or
"round").
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess

import torch

from rdeic_torch import build

ULP = 2.0 ** -23  # fp32's ulp at 1
TF32_ULP = 2.0 ** -10
KINDS = {"bf16": (0, 16), "tf32": (1, 8)}
WINDOW = range(1, 13)  # rows 8 + e: 1 - 2^-e ulp
SMALL = range(1, 9)  # rows 24 + e: k - 1 products of 2^-e ulp beside a 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_wgmma_probe()))
    vp = ctypes.c_void_p
    lib.rdeic_wgmma_probe.restype = ctypes.c_int
    lib.rdeic_wgmma_probe.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp]
    return lib


def product(kind: str, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """C + A B on the card: kind "bf16" (A [64][16], B [16][64]) or "tf32"
    (A [64][8], B [8][64]); C [64][64]; fp32 CUDA tensors."""
    code, k = KINDS[kind]
    a, b, c = (x.float().contiguous() for x in (a, b, c))
    if a.shape != (64, k) or b.shape != (k, 64) or c.shape != (64, 64):
        raise ValueError(f"{kind}: A [64, {k}], B [{k}, 64], C [64, 64]")
    d = torch.empty_like(c)
    err = _library().rdeic_wgmma_probe(
        code, a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma probe launch failed: {err}")
    torch.cuda.synchronize(a.device)
    return d


def cases(k: int):
    """(A, C): the rows of the rounding cases (module docstring)."""
    a = torch.zeros(64, k, dtype=torch.float64)
    c = torch.zeros(64, 64, dtype=torch.float64)
    a[0, :2] = torch.tensor([1.0, 0.75 * ULP])
    a[1, :2] = torch.tensor([-1.0, -0.75 * ULP])
    a[2, :2] = torch.tensor([1.0, 0.5 * ULP])
    a[3, 0], c[3] = 0.75 * ULP, 1.0
    a[4, 0], c[4] = -0.75 * ULP, -1.0
    a[5, 0], c[5] = 0.5 * ULP, 1.0
    for e in WINDOW:
        a[8 + e, :2] = torch.tensor([1.0, -(2.0 ** -e) * ULP])
    for e in SMALL:
        a[24 + e, 0] = 1.0
        a[24 + e, 1:] = 2.0 ** -e * ULP
    return a.float(), c.float()


def _mode(got: float, lo: float, hi: float, exact: float) -> str:
    """"rz" or "rn" for a sum whose exact value lies between lo and hi."""
    toward_zero = lo if abs(lo) < abs(hi) else hi
    nearest = lo if abs(exact - lo) < abs(exact - hi) else hi
    if got == toward_zero and got != nearest:
        return "rz"
    if got == nearest and got != toward_zero:
        return "rn"
    return f"neither ({got!r})"


def _tie(got: float) -> str:
    """1 + 0.5 ulp: 1 (toward zero, or to the even mantissa) or 1 + ulp."""
    return "rna" if got == 1.0 + ULP else "rz or rne" if got == 1.0 else repr(got)


def rounding(device=None) -> dict:
    """The readings of every case, by type (module docstring)."""
    device = device or torch.device("cuda")
    out = {}
    for kind, (_, k) in KINDS.items():
        a, c = cases(k)
        b = torch.ones(k, 64)
        col = 63  # tf32: column 63 of B reads B's operand case
        if kind == "tf32":
            a[40, 0] = 1.0 + 0.75 * TF32_ULP
            a[41, 0] = -(1.0 + 0.75 * TF32_ULP)
            a[42, 0] = 1.0 + 0.5 * TF32_ULP
            a[43, 0] = 1.0
            b[0, col] = 1.0 + 0.75 * TF32_ULP
        d = product(kind, a.to(device), b.to(device), c.to(device)).cpu()
        x = d[:, 0].double().tolist()
        one = 1.0
        r = {"sum": [_mode(x[0], one, one + ULP, one + 0.75 * ULP),
                     _mode(x[1], -one, -one - ULP, -one - 0.75 * ULP)],
             "tie": _tie(x[2]),
             "accumulate": [_mode(x[3], one, one + ULP, one + 0.75 * ULP),
                            _mode(x[4], -one, -one - ULP,
                                  -one - 0.75 * ULP)],
             "tie_accumulate": _tie(x[5]),
             "window": next((e for e in WINDOW if x[8 + e] == 1.0), None),
             "window_reads": {e: (x[8 + e] - 1.0) / ULP for e in WINDOW},
             "small": {e: (x[24 + e] - 1.0) / ULP for e in SMALL}}
        if kind == "tf32":
            r["operand_a"] = ("truncate" if x[40] == 1.0 and x[41] == -1.0
                              else "round" if x[40] == 1.0 + TF32_ULP
                              else repr((x[40], x[41])))
            r["operand_a_tie"] = x[42]
            r["operand_b"] = ("truncate" if d[43, col].item() == 1.0
                              else "round" if d[43, col].item()
                              == 1.0 + TF32_ULP else repr(d[43, col].item()))
        # a random product against float64 on the values the tensor core
        # reads (bf16, or tf32 cut from fp32): the fragment layouts
        g = torch.Generator().manual_seed(k)
        ra, rb, rc = (torch.randn(s, generator=g)
                      for s in ((64, k), (k, 64), (64, 64)))
        if kind == "bf16":
            ra, rb = ra.bfloat16().float(), rb.bfloat16().float()
        else:
            cut = ~0x1FFF
            ra, rb = ((x.view(torch.int32) & cut).view(torch.float32)
                      for x in (ra, rb))
        got = product(kind, ra.to(device), rb.to(device), rc.to(device)).cpu()
        want = rc.double() + ra.double() @ rb.double()
        r["random_max_abs_err"] = (got.double() - want).abs().max().item()
        out[kind] = r
    return out


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps(rounding()), flush=True)


if __name__ == "__main__":
    main()
