"""Time the flash backward at d = 16, 64 or 512 (bf16; fp32 at d = 64 and
512) on one card: this checkout's kernels, another checkout's, and
variants of this one's, in one process.

    python -m rdeic_torch.tools.flash_bwd_probe [--d 16|64|512]
        [--dtype bf16|fp32] [--other DIR [--bits]] [--variants [NAME ...]]

Builds `csrc/flash_attn_bwd.cu` of this checkout ("change"), of the
checkout at DIR ("other", e.g. the parent commit unpacked by `git
archive`) and, with --variants, copies of this one whose kernels at the
head dim and dtype (namespace `d16_bf16`, `d64_bf16`, `d512_bf16` or, in
fp32, `d64` and `d512`) are changed by the text substitutions in VARIANTS (all
of the namespace's, or those named; a substitution that no longer matches
raises). Prints the card's name and power limit and each build's ptxas
lines for those kernels (registers, spills, and any C7519: a
`warpgroup.arrive` that ptxas injected). Each library is called through its
C interface on the same inputs of the dtype, at the head dim's SHAPES; then
a JSON line per shape, version and pass (two passes, the second in reverse
order): dq's and dkv's device ms (`device_ms`: launches queued behind a
sleeping kernel, CUDA events) and ms back to back through ctypes (`ms`),
SDPA's backward in the dtype beside them, max |error| over max|plain| of
dq, dk and dv against the plain version's fp32 result, and whether a second
launch gave the same bits. Variants that compute something else say so in
VARIANTS: they time what a piece of the kernels costs. With --bits, first a
JSON line per BITS_CASES entry but the probed one (the fp32 and bf16
kernels at d = 16, 64 and 512): whether this checkout's dq, di, dk and dv
are the other checkout's bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
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
          64: [(2, 4096, 5, 64), (2, 1024, 10, 64), (1, 8192, 2, 64)],
          512: [(2, 4096, 1, 512), (1, 1024, 1, 512), (1, 8192, 1, 512)]}
# (head dim, dtype): the namespace of its dq and dkv kernels
NAMESPACES = {(16, "bf16"): "d16_bf16", (64, "bf16"): "d64_bf16",
              (512, "bf16"): "d512_bf16", (64, "fp32"): "d64",
              (512, "fp32"): "d512"}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# --bits: every dq / dkv kernel, at an L of no tile multiple with B = 2,
# H > 1 (d = 512: H = 2); the probed head dim and dtype are left out
BITS_CASES = [((2, 1000, 3, 16), torch.float32),
              ((2, 1000, 3, 64), torch.float32),
              ((2, 1000, 2, 512), torch.float32),
              ((2, 1000, 3, 16), torch.bfloat16),
              ((2, 1000, 3, 64), torch.bfloat16),
              ((2, 1000, 2, 512), torch.bfloat16)]
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
_D64_VARIANTS = {
    # P and dS as their big term alone (outside the limit)
    "one_term": [("    mma_m64n64k16_rs_mn(acc, small[kk], db + 128 * kk, 1);\n",
                  "")],
    # no exponentials: P = S c - lse2 (wrong values)
    "no_exp": [("exp2_ftz(fmaf(", "(fmaf(")],
    # a ring of two stages, not four
    "stages2": [("BN = 64, STAGES = 4;", "BN = 64, STAGES = 2;")],
    # two consumer warpgroups (128 kept rows) a block, one block an SM
    "two_wg": [("constexpr int NWG = 1,", "constexpr int NWG = 2,")],
    # dq's small-term products into an accumulator of their own, added at
    # the end: two independent wgmma chains, not one (other rounding)
    "dq_two_acc": [
        ("  float acc[D / 2];  // dq", "  float acc[D / 2], acc2[D / 2];  // dq"),
        ("for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;",
         "for (int i = 0; i < D / 2; ++i) acc[i] = acc2[i] = 0.f;"),
        ("    take_terms(acc, big, small, desc(sk + (j % STAGES) * kTile, kTile));",
         "    const uint64_t db = desc(sk + (j % STAGES) * kTile, kTile);\n"
         "#pragma unroll\n"
         "    for (int kk = 0; kk < BN / 16; ++kk) {\n"
         "      mma_m64n64k16_rs_mn(acc2, small[kk], db + 128 * kk, 1);\n"
         "      mma_m64n64k16_rs_mn(acc, big[kk], db + 128 * kk, 1);\n"
         "    }"),
        ("    fence_regs(acc);\n    __syncwarp();",
         "    fence_regs(acc);\n    fence_regs(acc2);\n    __syncwarp();"),
        ("  wgmma_wait<0>();\n  fence_regs(acc);\n",
         "  wgmma_wait<0>();\n  fence_regs(acc);\n  fence_regs(acc2);\n"
         "#pragma unroll\n"
         "  for (int i = 0; i < D / 2; ++i) acc[i] += acc2[i];\n")],
}
_SCORE_PASSES = """    mma_m64n32k8_ss_tf32(s, desc(as + ka), desc(bb + kb), kk);
    mma_m64n32k8_rs_tf32(s, ab[kk], desc(bs + kb), 1);
    mma_m64n32k8_rs_tf32(s, ab[kk], desc(bb + kb), 1);
"""
_PRODUCT_PASSES = """    mma_m64n64k8_rs_tf32(part, small[kk], desc(tb + 32 * kk), kk);
    mma_m64n64k8_rs_tf32(part, big[kk], desc(ts + 32 * kk), 1);
    mma_m64n64k8_rs_tf32(part, big[kk], desc(tb + 32 * kk), 1);
"""
_NARROW_PASSES = """        mma_m64n32k8_rs_tf32(part, small[kk], desc(tb + at), kk);
        mma_m64n32k8_rs_tf32(part, big[kk], desc(ts + at), 1);
        mma_m64n32k8_rs_tf32(part, big[kk], desc(tb + at), 1);
"""
_D64_FP32_VARIANTS = {
    # one TF32 pass a product, big * big (outside the limit): what the
    # three passes cost
    "one_pass": [(_SCORE_PASSES,
                  "    mma_m64n32k8_rs_tf32(s, ab[kk], desc(bb + kb), kk);\n"),
                 (_PRODUCT_PASSES,
                  "    mma_m64n64k8_rs_tf32(part, big[kk], desc(tb + 32 * kk), kk);\n"),
                 (_NARROW_PASSES,
                  "        mma_m64n32k8_rs_tf32(part, big[kk], desc(tb + at), kk);\n")],
    # no exponentials: P = S c - lse2 (wrong values)
    "no_exp": [("exp2f(fmaf(", "(fmaf(")],
    # the producer makes no operands (the consumers read stale planes:
    # wrong values): what the split costs the consumers
    "no_split": [("      split_tile<true>(raw, op + kKb,", "      if (0) split_tile<true>(raw, op + kKb,"),
                 ("      split_tile<false>(raw + kPlane,", "      if (0) split_tile<false>(raw + kPlane,"),
                 ("      split_tile<true>(raw, op + kQb,", "      if (0) split_tile<true>(raw, op + kQb,"),
                 ("      split_tile<true>(raw + kPlane, op + kDb,", "      if (0) split_tile<true>(raw + kPlane, op + kDb,")],
    # dkv's registers as dq's: producer 56, consumers 224
    "dkv_regs224": [("kDkvProducerRegs = 40, kDkvConsumerRegs = 232;",
                     "kDkvProducerRegs = 56, kDkvConsumerRegs = 224;")],
    # no half blocks: every tile a full block, the last wave as it falls
    "no_halves": [("g->halves = rem > 0 && 2 * rem <= sms ? rem : 0;",
                   "g->halves = 0 * rem;")],
    # full blocks' consumer warpgroups issue their scores when ready, not
    # in turns
    "no_turns": [("  if constexpr (!HALF) first_turn(wg);\n", ""),
                 ("    if constexpr (!HALF) take_turn(wg);\n", ""),
                 ("    if constexpr (!HALF) give_turn(wg, (j + 1) * BN >= L);\n",
                  "")],
    # ex2.approx.ftz for the exponentials (flash_bf16.cuh exp2_ftz)
    "ex2_approx": [("exp2f(fmaf(", "rdeic_flash::bf16::exp2_ftz(fmaf(")],
    # the first pass's A from registers (the big term again: wrong values):
    # what reading the small term from shared memory costs
    "no_ss": [("    mma_m64n32k8_ss_tf32(s, desc(as + ka), desc(bb + kb), kk);\n",
               "    mma_m64n32k8_rs_tf32(s, ab[kk], desc(bb + kb), kk);\n")],
}
_D512_FP32_VARIANTS = {
    # no exchange: no st.async and no waits, each block's softmax and
    # products on its own partial scores and stale slots (wrong values):
    # what the cluster's exchange costs
    "no_exchange": [
        ("  if (lane == 0) {\n    mbar_expect_tx(x.got_parts, (CL - 1) * 512);\n"
         "    mbar_expect_tx(x.got_sum, (CL - 1) * 32 * kSum);\n  }\n", ""),
        ("      st_async_v4(mapa(x.parts + rank * kSlot + mine, to), v,\n"
         "                  mapa(x.got_parts, to));\n", ""),
        ("  mbar_wait_cluster(x.got_parts, parity);\n", ""),
        ("  mbar_wait_cluster(x.got_sum, parity);\n", ""),
        ("    if constexpr (GATHER4)\n      st_async_v4(at, out, mapa(x.got_sum, to));\n"
         "    else\n      st_async_v2(at, make_float2(out.x, out.y), mapa(x.got_sum, to));\n",
         "")],
    # the splitters make no planes (the consumers read stale ones: wrong
    # values): what the split costs
    "no_split": [("      small_plane<SMALL>(st + kRawA, st + kSmallA, tid);\n"
                  "      small_plane<SMALL>(st + kRawB, st + kSmallB, tid);\n", ""),
                 ("      for (int x = 0; x < NTRANS; ++x)\n",
                  "      for (int x = 0; x < 0; ++x)\n")],
    # no products with P or dS (wrong values): what they cost
    "no_products": [("      d64::accumulate<", "      if (0) d64::accumulate<")],
    # no exponentials: P = S c - lse2 (wrong values)
    "no_exp": [("exp2f(fmaf(", "(fmaf(")],
    # dkv's partials as two 32-column halves of 16 registers, not one
    # m64n64k8 product of 32
    "dkv_narrow": [("d64::accumulate<false>(acc_v", "d64::accumulate<true>(acc_v"),
                   ("d64::accumulate<false>(acc_k", "d64::accumulate<true>(acc_k")],
    # dkv's consumers 232 registers, the producer 40
    "dkv_regs232": [("kDkvProducerRegs = 56, kDkvConsumerRegs = 224;",
                     "kDkvProducerRegs = 40, kDkvConsumerRegs = 232;")],
    # the producer's four warps split as one on the small planes and three
    # on the transposed ones, or three and one (landed: two and two)
    "dkv_small1": [("kDqSmallWarps = 2, kDkvSmallWarps = 2;",
                    "kDqSmallWarps = 2, kDkvSmallWarps = 1;")],
    "dq_small1": [("kDqSmallWarps = 2, kDkvSmallWarps = 2;",
                   "kDqSmallWarps = 1, kDkvSmallWarps = 2;")],
    "dq_small3": [("kDqSmallWarps = 2, kDkvSmallWarps = 2;",
                   "kDqSmallWarps = 3, kDkvSmallWarps = 2;")],
    # score rings of two slots, or four in dq (landed: three)
    "slots2": [("kDqScoreSlots = 3, kDkvScoreSlots = 3",
                "kDqScoreSlots = 2, kDkvScoreSlots = 2")],
    "dq_slots4": [("kDqScoreSlots = 3, kDkvScoreSlots = 3",
                   "kDqScoreSlots = 4, kDkvScoreSlots = 3")],
}
# namespace: {name: [(old, new)] in that namespace}
VARIANTS = {"d16_bf16": _D16_VARIANTS, "d64_bf16": _D64_VARIANTS,
            "d512_bf16": _D512_VARIANTS, "d64": _D64_FP32_VARIANTS,
            "d512": _D512_FP32_VARIANTS}


def variant_source(src: str, edits, namespace: str) -> str:
    """`src` with each (old, new) applied inside `namespace`."""
    i0 = src.index(f"namespace {namespace} {{")
    i1 = src.index(f"}}  // namespace {namespace}\n")
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


def ptxas_lines(lib: Path, d: int, dtype: str = "bf16") -> list[str]:
    """The build log's ptxas lines for the head dim's kernels of the dtype:
    each one's registers and spills, and every C7519 warning."""
    out, name = [], None
    suffix = "_bf16" if dtype == "bf16" else ""
    for line in build.build_log(lib).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            m = re.search(rf"(flash_d(?:q|kv)_d{d}{suffix})(?=[EI])", entry[1])
            name = m[1] if m else None
        elif "C7519" in line:
            out.append(line.strip())
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


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


def _runners(lib, inputs):
    """(run_dq, run_dkv, (dq, di, dk, dv)): `lib`'s two launches on
    `inputs` (q, k, v, o, lse, dO; fp32 or bf16) into fresh outputs."""
    q, k, v, o, lse, do = inputs
    b, seq, h, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di = torch.empty_like(lse)
    st = torch.cuda.current_stream().cuda_stream
    ptr = [x.data_ptr() for x in (q, k, v, o, lse, do, dq, di, dk, dv)]
    code = 1 if q.dtype == torch.bfloat16 else 0
    dims = (b, seq, h, d, code, d ** -0.5, st)

    def run_dq():
        return lib.rdeic_flash_attn_bwd_dq(*ptr[:4], ptr[5], ptr[4], ptr[6],
                                           ptr[7], *dims)

    def run_dkv():
        return lib.rdeic_flash_attn_bwd_dkv(*ptr[:3], ptr[5], ptr[4], ptr[7],
                                            ptr[8], ptr[9], *dims)

    return run_dq, run_dkv, (dq, di, dk, dv)


def probe(lib, shape, inputs, plain) -> dict:
    """dq and dkv of `lib` on `inputs`: device ms and errors."""
    run_dq, run_dkv, (dq, di, dk, dv) = _runners(lib, inputs)
    rcs = (run_dq(), run_dkv())
    if rcs != (0, 0):
        return {"launch_errors": rcs}
    torch.cuda.synchronize()
    errs = [((g.float() - w).abs().max() / w.abs().max()).item()
            for g, w in zip((dq, dk, dv), plain)]
    first = [x.clone() for x in (dq, di, dk, dv)]
    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, (dq, di, dk, dv)))
    t_dq, t_dkv = device_ms(run_dq), device_ms(run_dkv)
    ms = {}
    for name, fn in (("dq", run_dq), ("dkv", run_dkv)):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / 20
    return {"dq": t_dq, "dkv": t_dkv, "pair": t_dq + t_dkv,
            "ms": ms["dq"] + ms["dkv"], "errs": errs, "same_bits": same}


def _inputs(shape, dtype, seed=0):
    """q, k, v, o, lse, dO on the card: normal draws, o and lse from the
    lse forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    o, lse = flash_attention_lse(q, k, v)
    return q, k, v, o, lse, do


def same_bits(other, change, probed=None) -> None:
    """A JSON line per BITS_CASES entry but the `probed` (head dim, dtype):
    whether the two libraries give the same dq, di, dk and dv bits (the
    kernels a change leaves as they were)."""
    for shape, dtype in BITS_CASES:
        if (shape[3], dtype) == probed:
            continue
        inputs = _inputs(shape, dtype, seed=1)
        outs = []
        for lib in (other, change):
            run_dq, run_dkv, out = _runners(lib, inputs)
            if (run_dq(), run_dkv()) != (0, 0):
                raise RuntimeError(f"launch failed at {shape}")
            outs.append(out)
        torch.cuda.synchronize()
        print(json.dumps({"bits": shape, "dtype": str(dtype).split(".")[-1],
                          "same": all(torch.equal(a, b)
                                      for a, b in zip(*outs))}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, choices=sorted(SHAPES), default=16,
                    help="head dim")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="the kernels' dtype (fp32 at d = 64 and 512)")
    ap.add_argument("--other", type=Path, help="another checkout to time")
    ap.add_argument("--bits", action="store_true",
                    help="with --other: whether the kernels at BITS_CASES "
                    "give the other checkout's bits")
    ap.add_argument("--variants", nargs="*",
                    help="time the head dim's VARIANTS (all, or those named)")
    args = ap.parse_args()
    if (args.d, args.dtype) not in NAMESPACES:
        ap.error(f"no {args.dtype} kernels of their own at d = {args.d}")
    dtype = DTYPES[args.dtype]
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
    if args.variants is not None:
        ns = NAMESPACES[args.d, args.dtype]
        jobs.update({n: (csrc, variant_source(src, e, ns))
                     for n, e in VARIANTS[ns].items()
                     if not args.variants or n in args.variants})
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {n: pool.submit(_library, n, c, s, out_dir)
                   for n, (c, s) in jobs.items()}
        paths = {n: f.result() for n, f in futures.items()}
    for n, path in paths.items():
        for line in ptxas_lines(path, args.d, args.dtype):
            print(f"[ptxas] {n} {line}", flush=True)
    libs = {n: _bind(path) for n, path in paths.items()}
    order = list(libs)
    if "other" in libs:  # other, change, ..., then back: change, other
        order = ["other"] + [n for n in order if n != "other"]
    if args.bits:
        same_bits(libs["other"], libs["change"], (args.d, dtype))
    for shape in SHAPES[args.d]:
        q, k, v, o, lse, do = _inputs(shape, dtype)
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
