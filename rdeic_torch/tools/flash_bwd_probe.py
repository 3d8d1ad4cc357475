"""Time the bf16 flash backward at d = 16 or d = 512 on one card: this
checkout's kernels, another checkout's, and variants of this one's, in one
process.

    python -m rdeic_torch.tools.flash_bwd_probe [--d 16|512] [--other DIR]
        [--variants]

Builds `csrc/flash_attn_bwd.cu` of this checkout ("change"), of the
checkout at DIR ("other", e.g. the parent commit unpacked by `git
archive`) and, with --variants, copies of this one whose kernels at the
head dim (namespace `d16_bf16` or `d512_bf16`) are changed by the text
substitutions in VARIANTS (a substitution that no longer matches raises).
Each library is called through its C interface on the same bf16 inputs, at
the head dim's SHAPES. Prints the card's name and power limit, then a JSON
line per shape, version and pass (two passes, the second in reverse
order): dq's and dkv's device ms (`device_ms`: launches queued behind a
sleeping kernel, CUDA events), SDPA's bf16 backward beside them, and max
|error| over max|plain| of dq, dk and dv against the plain version's fp32
result. Variants that compute something else say so in VARIANTS: they time
what a piece of the kernels costs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from rdeic_torch import build
from rdeic_torch.ops.flash_attention import (
    flash_attention_bwd_plain,
    flash_attention_lse,
)

SHAPES = {16: [(2, 4096, 4, 16), (2, 1024, 8, 16), (1, 8192, 4, 16)],
          512: [(2, 4096, 1, 512), (1, 1024, 1, 512), (1, 8192, 1, 512)]}
NAMESPACES = {16: "d16_bf16", 512: "d512_bf16"}
SLEEP_CLOCK_HZ = 2.0e9  # torch.cuda._sleep counts cycles, at most this fast
_SMALL_MMA = """    bf16::mma(acc[0], small, f[0], f[1]);
    bf16::mma(acc[1], small, f[2], f[3]);
"""
_SMALL_MMA_512 = """#pragma unroll
    for (int m = 0; m < MT; ++m) {
      bf16::mma(acc[m][2 * np], small[m], f[0], f[1]);
      bf16::mma(acc[m][2 * np + 1], small[m], f[2], f[3]);
    }
"""
_D16_VARIANTS = {
    # big rounded to nearest: two conversions a pair (pack_split, as at d = 64)
    "pack_split": [("bf16::pack_split_trunc(", "bf16::pack_split(")],
    # P and dS as their big term alone (outside the limit)
    "one_term": [(_SMALL_MMA, "")],
    # no exponentials: P = S c - lse2 (wrong values)
    "no_exp": [("exp2_ftz(fmaf(", "(fmaf(")],
    # 60 KB of dynamic shared memory a block: two blocks per SM, not four
    "two_blocks": [("<<<grid, NT, 0, stream>>>", "<<<grid, NT, 61440, stream>>>"),
                   ("prepare_on_device(flash_dq_d16_bf16, 0,",
                    "prepare_on_device(flash_dq_d16_bf16, 61440,"),
                   ("prepare_on_device(flash_dkv_d16_bf16, 0,",
                    "prepare_on_device(flash_dkv_d16_bf16, 61440,")],
    "chunk16": [("NT = 128, KC = 32;", "NT = 128, KC = 16;")],
    "chunk64": [("NT = 128, KC = 32;", "NT = 128, KC = 64;")],
    # the small term's products into accumulators of their own, added at
    # the end (no dependent mma between the two terms)
    "split_acc": [
        (_SMALL_MMA, _SMALL_MMA.replace("acc[0]", "acc[2]").replace(
            "acc[1]", "acc[3]")),
        ("void accumulate(float (&acc)[2][4],", "void accumulate(float (&acc)[4][4],"),
        ("  float acc[2][4];  // dq", "  float acc[4][4];  // dq"),
        ("  float acc_k[2][4], acc_v[2][4];", "  float acc_k[4][4], acc_v[4][4];"),
        ("  store_rows(dq + base, acc,",
         "  fold(acc);\n  store_rows(dq + base, reinterpret_cast<float (&)[2][4]>(acc),"),
        ("  store_rows(dk + base, acc_k,",
         "  fold(acc_k);\n  store_rows(dk + base, reinterpret_cast<float (&)[2][4]>(acc_k),"),
        ("  store_rows(dv + base, acc_v,",
         "  fold(acc_v);\n  store_rows(dv + base, reinterpret_cast<float (&)[2][4]>(acc_v),"),
        ("constexpr int kRow = D * 2;",
         "__device__ __forceinline__ void fold(float (&a)[4][4]) {\n"
         "  for (int n = 0; n < 2; ++n)\n"
         "    for (int i = 0; i < 4; ++i) a[n][i] += a[n + 2][i];\n}\n"
         "constexpr int kRow = D * 2;")],
}
_D512_VARIANTS = {
    # P and dS as their big term alone (outside the limit)
    "one_term": [(_SMALL_MMA_512, "")],
    # big rounded to nearest: two conversions a pair
    "pack_split": [("bf16::pack_split_trunc(", "bf16::pack_split(")],
    # no ldmatrix and no mma: the copies, barriers, exchanges and softmax
    # alone (wrong values): the floor the L2 -> SM copies set
    "copies_only": [("for (int kk = 0; kk < D / 16; ++kk) {",
                     "for (int kk = 0; kk < 0; ++kk) {"),
                    ("for (int np = 0; np < kSlice / 16; ++np) {",
                     "for (int np = 0; np < 0; ++np) {")],
    # no streamed copies after the first tile: the kernels' work on tiles
    # already in shared memory (wrong values), to see whether the copies
    # hide under it
    "no_copies": [("if (j + 1 < nk) {", "if (false) {"),
                  ("if (j + 1 < nq) {", "if (false) {")],
    # the scores alone: no products with P or dS (wrong values)
    "no_products": [("for (int np = 0; np < kSlice / 16; ++np) {",
                     "for (int np = 0; np < 0; ++np) {")],
    # dq keeps 32 q rows and streams 32-key tiles: twice the K and V bytes
    # through L2, the same patches (dkv's other heights do not fit: 64 kept
    # keys need 256 accumulators a thread, 16 need 64-row streamed tiles,
    # 256 KB double-buffered)
    "dq_kept32": [("DQ_KEPT = 64, DQ_STREAM = 16,",
                   "DQ_KEPT = 32, DQ_STREAM = 32,")],
}
# namespace: {name: [(old, new)] in that namespace}
VARIANTS = {"d16_bf16": _D16_VARIANTS, "d512_bf16": _D512_VARIANTS}


def variant_source(src: str, edits, namespace: str) -> str:
    """`src` with each (old, new) applied inside `namespace`."""
    i0 = src.index(f"namespace {namespace} {{")
    i1 = src.index(f"}}  // namespace {namespace}")
    ns = src[i0:i1]
    for old, new in edits:
        if old not in ns:
            raise ValueError(f"variant text not in {namespace}: {old!r}")
        ns = ns.replace(old, new)
    return src[:i0] + ns + src[i1:]


def _library(name: str, csrc: Path, source: str, out_dir: Path) -> Path:
    src = out_dir / f"flash_attn_bwd_{name}.cu"
    src.write_text(source)
    headers = tuple(csrc / h.name for h in build.FLASH_HEADERS)
    return build._build(src, f"flash_attn_bwd_{name}",
                        build._nvcc_cmd() + ["-I", str(csrc)], headers)


def device_ms(fn, reps: int = 20) -> float:
    """Device ms a launch of fn(): `reps` launches queued behind a sleeping
    kernel (so no host time is in the window), the shorter of two windows."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reads = []
    for _ in range(2):
        torch.cuda._sleep(int(SLEEP_CLOCK_HZ * (3 * host * reps + 5e-3)))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        reads.append(start.elapsed_time(end) / reps)
    return min(reads)


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for f in (lib.rdeic_flash_attn_bwd_dq, lib.rdeic_flash_attn_bwd_dkv):
        f.restype = i
        f.argtypes = [vp] * 8 + [i] * 5 + [ctypes.c_float, vp]
    return lib


def probe(lib, shape, inputs, plain) -> dict:
    """dq and dkv of `lib` on `inputs`: device ms and errors."""
    q, k, v, o, lse, do = inputs
    b, seq, h, d = shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di = torch.empty_like(lse)
    st = torch.cuda.current_stream().cuda_stream
    ptr = [x.data_ptr() for x in (q, k, v, o, lse, do, dq, di, dk, dv)]
    dims = (b, seq, h, d, 1, d ** -0.5, st)  # dtype 1: bf16

    def run_dq():
        return lib.rdeic_flash_attn_bwd_dq(*ptr[:4], ptr[5], ptr[4], ptr[6],
                                           ptr[7], *dims)

    def run_dkv():
        return lib.rdeic_flash_attn_bwd_dkv(*ptr[:3], ptr[5], ptr[4], ptr[7],
                                            ptr[8], ptr[9], *dims)

    if run_dq() != 0 or run_dkv() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    errs = [((g.float() - w).abs().max() / w.abs().max()).item()
            for g, w in zip((dq, dk, dv), plain)]
    t_dq, t_dkv = device_ms(run_dq), device_ms(run_dkv)
    return {"dq": t_dq, "dkv": t_dkv, "pair": t_dq + t_dkv, "errs": errs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, choices=sorted(SHAPES), default=16,
                    help="head dim")
    ap.add_argument("--other", type=Path, help="another checkout to time")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    csrc = Path(build.FLASH_BWD_SRC).parent
    src = build.FLASH_BWD_SRC.read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"change": (csrc, src)}
    if args.other:
        other = args.other.resolve() / "rdeic_torch" / "csrc"
        jobs["other"] = (other, (other / "flash_attn_bwd.cu").read_text())
    if args.variants:
        ns = NAMESPACES[args.d]
        jobs.update({n: (csrc, variant_source(src, e, ns))
                     for n, e in VARIANTS[ns].items()})
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {n: pool.submit(_library, n, c, s, out_dir)
                   for n, (c, s) in jobs.items()}
        libs = {n: _bind(f.result()) for n, f in futures.items()}
    order = list(libs)
    if "other" in libs:  # other, change, ..., then back: change, other
        order = ["other"] + [n for n in order if n != "other"]
    dev = torch.device("cuda")
    for shape in SHAPES[args.d]:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = flash_attention_lse(q, k, v)
        plain = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)),
                                          lse, do.float())
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        sdpa = device_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        for p, names in enumerate((order, order[::-1])):
            for name in names:
                r = probe(libs[name], shape, (q, k, v, o, lse, do), plain)
                print(json.dumps({"version": name, "shape": shape, "pass": p,
                                  **r, "sdpa_bwd": sdpa}), flush=True)


if __name__ == "__main__":
    main()
