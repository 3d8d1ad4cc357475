"""Time the d = 16, 64 or 512 flash forward on one card: this checkout's
kernels, another checkout's, and variants of this one's, in one process.

    python -m rdeic_torch.tools.flash_fwd_probe [--d 16|64|512]
        [--dtype bf16|fp32] [--other DIR [--bits]] [--variants NAME ...]
        [--shapes B,L,H ...]

Builds `csrc/flash_attn_fwd.cu` of this checkout ("change"), of the
checkout at DIR ("other", e.g. the parent commit unpacked by `git
archive`) and, with --variants, copies of this one whose kernel of the
head dim and dtype (namespace `d16_bf16`, `d16`, `d64_bf16`, `d64`,
`d512_bf16` or `d512`) is changed by the text substitutions in VARIANTS
(a substitution that no longer matches raises; NAME+NAME applies
several); prints each build's ptxas registers, spills and C75xx
advisories (wgmma serialized). Each library is called through its C
interface on the same inputs, with and without lse, at the head dim's
SHAPES (the serving, training, validation, batched and tiled shapes, and
checks); a library that takes scratch (the fp32 d = 16 forward) gets it
once a size.
With --bits, first a JSON line per BITS_CASES entry of another head dim
(every forward kernel but the probed head dim's two): whether this
checkout's output and lse are the other checkout's bit for bit.
Prints the card's name and power limit, then a JSON line per shape,
version and pass (two passes, the second in reverse order): the device ms
a launch (`device_ms`: launches queued behind a sleeping kernel, CUDA
events), the ms a launch back to back through ctypes (`ms`), SDPA's call
in the same dtype beside them, and max |error| of the output against the
plain version (bf16: in bf16 ulps of max|plain|; fp32: absolute) and of
the lse over its max.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from rdeic_torch import build
from rdeic_torch.ops.flash_attention import flash_attention_lse_plain

SHAPES = {16: [(1, 6144, 4, 16), (1, 1536, 8, 16), (2, 4096, 4, 16),
              (2, 1024, 8, 16), (1, 4096, 4, 16), (1, 1024, 8, 16),
              (2, 6144, 4, 16), (2, 1536, 8, 16), (4, 4096, 4, 16),
              (4, 1024, 8, 16), (15, 4096, 4, 16), (2, 1000, 3, 16),
              (1, 130, 1, 16), (1, 8192, 4, 16)],
          64: [(1, 6144, 5, 64), (1, 1536, 10, 64), (2, 4096, 5, 64),
               (2, 1024, 10, 64), (2, 6144, 5, 64), (4, 4096, 5, 64),
               (2, 1000, 3, 64), (1, 130, 2, 64), (1, 8192, 2, 64)],
          512: [(1, 6144, 1, 512), (2, 4096, 1, 512), (1, 4096, 1, 512),
                (2, 6144, 1, 512), (4, 6144, 1, 512), (15, 4096, 1, 512),
                (1, 1024, 1, 512), (2, 1000, 2, 512), (1, 130, 1, 512),
                (1, 8192, 1, 512)]}
# (head dim, dtype): the namespace of its forward kernel
NAMESPACES = {(16, "bf16"): "d16_bf16", (16, "fp32"): "d16",
              (64, "bf16"): "d64_bf16", (64, "fp32"): "d64",
              (512, "bf16"): "d512_bf16", (512, "fp32"): "d512"}
# --bits: every forward kernel, at an L of no tile multiple with B = 2 and
# H > 1; the probed head dim's are left out
BITS_CASES = [((2, 1000, 3, 16), "fp32"), ((2, 1000, 3, 16), "bf16"),
              ((2, 1000, 3, 64), "fp32"), ((2, 1000, 3, 64), "bf16"),
              ((2, 1000, 2, 512), "fp32"), ((2, 1000, 2, 512), "bf16")]
DTYPES = {"bf16": (torch.bfloat16, 1), "fp32": (torch.float32, 0)}
SLEEP_CLOCK_HZ = 2.0e9  # torch.cuda._sleep counts cycles, at most this fast
# namespace: {name: [(old, new)] in that namespace}
VARIANTS = {
    # the d = 16 designs' choices, each against what it chose, and parts
    # left out (wrong by design: each times its part)
    "d16_bf16": {
        # 128-key tiles (S one m64n128k16) at two blocks an SM
        "bk128_blocks2": [("BK = 64, STAGES = 8, NT = 160,\n"
                           "              kBlocksPerSm = 3;",
                           "BK = 128, STAGES = 4, NT = 160,\n"
                           "              kBlocksPerSm = 2;")],
        "stages4": [("BK = 64, STAGES = 8,", "BK = 64, STAGES = 4,")],
        "no_exp": [("          x = exp2_ftz(fmaf(x, c, -m_new));",
                    "          x = fmaf(x, c, -m_new);")],
        "no_pv": [("    for (int kk = 0; kk < BK / 16; ++kk)\n"
                   "      mma_m64n16k16_rs_mn(",
                   "    for (int kk = 0; kk < 0; ++kk)\n"
                   "      mma_m64n16k16_rs_mn(")],
    },
    "d16": {
        # three or five consumers; P V in one group a tile (P's terms of
        # all eight steps live at once) or in groups of two steps
        "cons3": [("BK = 64, NC = 4, STAGES = 8,", "BK = 64, NC = 3, STAGES = 9,")],
        "cons5": [("BK = 64, NC = 4, STAGES = 8,", "BK = 64, NC = 5, STAGES = 10,")],
        "pv_whole": [("PV_STEPS = 4;", "PV_STEPS = 8;")],
        "pv_quarters": [("PV_STEPS = 4;", "PV_STEPS = 2;")],
        # P V's 24 instructions a tile as two chains (even and odd 8-key
        # steps) summed in fp32 before the join
        "pv_two_chains": [
            ("  float pv[D / 2];   // a tile's P V, from zero",
             "  float pv[D / 2], pv2[D / 2];"),
            ("        mma_m64n16k8_rs_tf32(pv, ps[i], vb + at, kk);\n"
             "        mma_m64n16k8_rs_tf32(pv, pb[i], vs + at, 1);\n"
             "        mma_m64n16k8_rs_tf32(pv, pb[i], vb + at, 1);\n",
             "        float(&pd)[D / 2] = (kk & 1) ? pv2 : pv;\n"
             "        mma_m64n16k8_rs_tf32(pd, ps[i], vb + at, kk >> 1);\n"
             "        mma_m64n16k8_rs_tf32(pd, pb[i], vs + at, 1);\n"
             "        mma_m64n16k8_rs_tf32(pd, pb[i], vb + at, 1);\n"),
            ("    fence_regs(pv);\n    __syncwarp();",
             "    fence_regs(pv);\n    fence_regs(pv2);\n    __syncwarp();"),
            ("      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);",
             "      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i] + pv2[i]);")],
        "no_exp": [("          xv = exp2_ftz(fmaf(xv, c, -m_new));",
                    "          xv = fmaf(xv, c, -m_new);")],
        "no_pv": [("    for (int k0 = 0; k0 < BK / 8; k0 += PV_STEPS) {",
                   "    for (int k0 = 0; k0 < 0; k0 += PV_STEPS) {")],
    },
    "d64_bf16": {
        "stages2": [("BK = 128, STAGES = 4,", "BK = 128, STAGES = 2,")],
    },
    "d64": {
        "producer48": [("kProducerRegs = 56,", "kProducerRegs = 48,")],
    },
    # the d = 512 designs' choices, each against what it chose
    "d512_bf16": {
        # no overlap: P V of tile j - 1 waited for before S of tile j
        "serial": [("    issue_s(j);\n    issue_pv(j - 1);\n",
                    "    issue_pv(j - 1);\n    wgmma_wait<0>();\n"
                    "    issue_s(j);\n")],
    },
    "d512": {
        # no exchange: each block's softmax on its own partial scores
        # (wrong by design: times the exchange)
        "no_exchange": [("      exchange(n, sc);\n", "")],
        # the splitters make nothing (wrong by design: times whether the
        # consumers wait for them)
        "no_split": [("        for (int i = tid; i < kTile / 16; i += NS) {",
                      "        for (int i = tid; i < 0; i += NS) {"),
                     ("        for (int c = ws; c < DC / 4; c += NS / 32) {",
                      "        for (int c = ws; c < 0; c += NS / 32) {")],
        # more registers for the splitters, fewer for the consumers
        "producer72": [("kProducerRegs = 56, kConsumerRegs = 224;",
                        "kProducerRegs = 72, kConsumerRegs = 216;")],
        "producer88": [("kProducerRegs = 56, kConsumerRegs = 224;",
                        "kProducerRegs = 88, kConsumerRegs = 208;")],
        # one fewer pass of S (wrong by design: times a third of S)
        "s_two_passes": [("        mma_m64n32k8_rs_tf32(sc, qb[kk], ks, 1);\n",
                          "")],
        # P V in one pass (wrong by design: times two thirds of P V)
        "pv_one_pass": [("          mma_m64n64k8_rs_tf32(pv, as, vb, kk);\n"
                         "          mma_m64n64k8_rs_tf32(pv, ab, vs, 1);\n"
                         "          mma_m64n64k8_rs_tf32(pv, ab, vb, 1);\n",
                         "          mma_m64n64k8_rs_tf32(pv, ab, vb, kk);\n")],
    },
}


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
    src = out_dir / f"flash_attn_fwd_{name}.cu"
    src.write_text(source)
    headers = tuple(h for h in (csrc / p.name for p in build.FLASH_HEADERS)
                    if h.exists())
    return build._build(src, f"flash_attn_fwd_{name}",
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


def back_to_back_ms(fn, reps: int = 20) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bind(path: Path):
    """The library's forward as fwd(q, k, v, o, lse, b, seq, h, d, code,
    scale, stream) on pointers; where the library takes scratch (the fp32
    d = 16 forward's operand images), fwd allocates it once per size and
    passes it."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rdeic_flash_attn_fwd.restype = i
    args = [vp] * 5 + [i] * 5 + [ctypes.c_float, vp]
    if not hasattr(lib, "rdeic_flash_attn_fwd_scratch_bytes"):
        lib.rdeic_flash_attn_fwd.argtypes = args
        return lib.rdeic_flash_attn_fwd
    lib.rdeic_flash_attn_fwd.argtypes = args + [vp]
    lib.rdeic_flash_attn_fwd_scratch_bytes.restype = ctypes.c_int64
    lib.rdeic_flash_attn_fwd_scratch_bytes.argtypes = [i] * 5
    scratch = {}

    def fwd(*a):
        nbytes = lib.rdeic_flash_attn_fwd_scratch_bytes(*a[5:10])
        if nbytes and nbytes not in scratch:
            scratch[nbytes] = torch.empty(nbytes, dtype=torch.uint8,
                                          device="cuda")
        return lib.rdeic_flash_attn_fwd(
            *a, scratch[nbytes].data_ptr() if nbytes else None)

    return fwd


def same_bits(other, change, probed_d) -> None:
    """A JSON line per BITS_CASES entry of another head dim than the probed
    one (whose kernels, both dtypes, the probe times): whether the two
    libraries give the same output and lse bits."""
    dev = torch.device("cuda")
    for shape, dt in BITS_CASES:
        if shape[-1] == probed_d:
            continue
        dtype, code = DTYPES[dt]
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        b, seq, h, d = shape
        got = []
        for lib in (other, change):
            o = torch.empty_like(q)
            lse = torch.empty((b * h, seq), device=dev, dtype=torch.float32)
            err = lib(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, seq, h, d, code, d ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: {err}")
            torch.cuda.synchronize()
            got.append((o, lse))
        print(json.dumps({"bits": shape, "dtype": dt,
                          "same_o": torch.equal(got[0][0], got[1][0]),
                          "same_lse": torch.equal(got[0][1], got[1][1])}),
              flush=True)


def probe(lib, shape, code, inputs, want) -> dict:
    """The forward of `lib` on `inputs`, with and without lse: ms and
    errors."""
    q, k, v = inputs
    b, seq, h, d = shape
    o = torch.empty_like(q)
    lse = torch.empty((b * h, seq), device=q.device, dtype=torch.float32)
    st = torch.cuda.current_stream().cuda_stream
    ptr = [x.data_ptr() for x in (q, k, v, o)]
    dims = (b, seq, h, d, code, d ** -0.5, st)
    out = {}
    for name, lp in (("plain", None), ("lse", lse.data_ptr())):
        def run(lp=lp):
            return lib(*ptr, lp, *dims)

        err = run()
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
        torch.cuda.synchronize()
        w_o, w_lse = want
        e = (o.float() - w_o).abs().max().item()
        if q.dtype == torch.bfloat16:
            e /= 2.0 ** (math.floor(math.log2(w_o.abs().max().item())) - 7)
        out[name] = {"device_ms": device_ms(run), "ms": back_to_back_ms(run),
                     "err": e}
        if lp is not None:
            out[name]["lse_err"] = ((lse - w_lse).abs().max()
                                    / w_lse.abs().max()).item()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, choices=sorted(SHAPES), default=64)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--other", type=Path, help="another checkout to time")
    ap.add_argument("--bits", action="store_true",
                    help="with --other: whether the other forward kernels "
                    "give the other checkout's bits")
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,L,H at the head dim (default: SHAPES)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    csrc = Path(build.FLASH_SRC).parent
    src = build.FLASH_SRC.read_text()
    out_dir = build.BUILD_DIR / "probe_fwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"change": (csrc, src)}
    if args.other:
        other = args.other.resolve() / "rdeic_torch" / "csrc"
        jobs["other"] = (other, (other / "flash_attn_fwd.cu").read_text())
    ns = NAMESPACES[args.d, args.dtype]
    jobs.update({n: (csrc, variant_source(
        src, [e for part in n.split("+") for e in VARIANTS[ns][part]], ns))
                 for n in args.variants})
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {n: pool.submit(_library, n, c, s, out_dir)
                   for n, (c, s) in jobs.items()}
        paths = {n: f.result() for n, f in futures.items()}
    kernel = f"flash_fwd_d{args.d}{'_bf16' if args.dtype == 'bf16' else ''}E"
    for name, path in paths.items():  # ptxas: registers, spills, C7519
        ours = False
        for line in build.build_log(path).splitlines():
            if "Compiling entry function" in line:
                ours = kernel in line
            elif (ours and ("registers" in line or "spill" in line)
                  or "C75" in line):  # C75xx: wgmma performance advisories
                print(name, line.strip(), flush=True)
    libs = {n: _bind(p) for n, p in paths.items()}
    if args.bits:
        same_bits(libs["other"], libs["change"], args.d)
    order = list(libs)
    if "other" in libs:  # other, change, ..., then back: change, other
        order = ["other"] + [n for n in order if n != "other"]
    dtype, code = DTYPES[args.dtype]
    shapes = ([tuple(int(x) for x in s.split(",")) + (args.d,)
               for s in args.shapes] if args.shapes else SHAPES[args.d])
    dev = torch.device("cuda")
    for shape in shapes:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        want = flash_attention_lse_plain(q.float(), k.float(), v.float())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt)

        lib_ms = {"sdpa_device_ms": device_ms(sdpa),
                  "sdpa_ms": back_to_back_ms(sdpa)}
        for p, names in enumerate((order, order[::-1])):
            for name in names:
                r = probe(libs[name], shape, code, (q, k, v), want)
                print(json.dumps({"version": name, "dtype": args.dtype,
                                  "shape": shape, "pass": p, **r, **lib_ms}),
                      flush=True)


if __name__ == "__main__":
    main()
