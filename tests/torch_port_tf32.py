"""The tensor-core arithmetic of the flash kernels, emulated on the CPU.

Shared by the tests that hold the kernels' numeric design to the Pallas
kernels and to the plain versions (`tests/test_torch_port_tf32_split.py`,
`tests/test_torch_port_flash_d16.py`, `tests/test_torch_port_flash_bf16.py`,
`tests/test_torch_port_flash_bwd_d64_bf16.py`,
`tests/test_torch_port_flash_bwd_d64_fp32.py`,
`tests/test_torch_port_flash_bwd_d16_bf16.py`):
TF32 rounding and the 3xTF32 split of `rdeic_torch/csrc/flash_mma.cuh`,
bf16 rounding and truncation, `mma.sync`'s rounding toward zero (TF32 and
bf16 products), `wgmma`'s rounding as the card shows it (the Hopper
kernels), 3xTF32 over the d = 64 backward's 32-row streamed tiles, the
addresses `wgmma` reads in the 128-, 64- and 32-byte swizzles, and the
shared-memory banks that a fragment read touches; and `one_torch_thread`,
the fixture these files run under.
"""
import numpy as np
import pytest
import torch

from rdeic_torch.ops.flash_attention import flash_attention_lse_plain

_DROP = 0x1FFF  # the 13 low mantissa bits fp32 has and TF32 has not


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test on one torch thread. An emulation is thousands of small
    tensor ops; beside the other test workers, each op's thread pool fights
    theirs for the cores and a test of seconds takes minutes. Import it
    into a test module to apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero (cvt.rna's
    rounding, done as the kernels do it: add bit 12, clear the 13 bits)."""
    bits = x.float().view(torch.int32).to(torch.int64)
    out = ((bits + 0x1000) & ~_DROP).to(torch.int32)
    return out.view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: the 13 low bits dropped."""
    return (x.float().view(torch.int32) & ~_DROP).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_round(x)
    return big, tf32_truncate(x.float() - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 from 3xTF32: small * big + big * small + big * big,
    each product of TF32 values exact in fp32 and summed in fp32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 pass: both operands rounded once."""
    return tf32_round(a) @ tf32_round(b)


def mm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


# -- the tensor core's rounding ----------------------------------------------
# mma.sync rounds the sum it returns toward zero, not to nearest. Modelled
# here: each pass's 8 TF32 products are summed exactly (float64) with the
# accumulator given to it, and the result is truncated to fp32.


def rz32(x: torch.Tensor) -> torch.Tensor:
    """float64 x to fp32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mma_3xtf32(a: torch.Tensor, b: torch.Tensor, c=0.0) -> torch.Tensor:
    """c + a @ b as 8-deep mma.sync steps of three passes each (small * big,
    big * small, big * big), every pass rounded toward zero (rz32)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    steps = a.shape[-1] // 8

    def step_sums(x, y):  # [step, ..., M, N]: each step's exact sum
        return (x.double().unflatten(-1, (steps, 8)).movedim(-2, 0)
                @ y.double().unflatten(-2, (steps, 8)).movedim(-3, 0))

    passes = [step_sums(x, y) for x, y in ((as_, bb), (ab, bs), (ab, bb))]
    c = torch.as_tensor(c, dtype=torch.float32)
    for i in range(steps):
        for p in passes:
            c = rz32(c.double() + p[i])
    return c


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as __floats2bfloat162_rn), in fp32."""
    return x.to(torch.bfloat16).float()


def bf16_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 x cut to bf16 (its top 16 bits: toward zero), in fp32."""
    return (x.float().view(torch.int32) & ~0xFFFF).view(torch.float32)


def mma_bf16(a: torch.Tensor, b: torch.Tensor, c=0.0) -> torch.Tensor:
    """c + a @ b as 16-deep bf16 mma.sync steps (m16n8k16): a and b hold
    bf16 values, so every product is exact; each step's exact sum joins the
    accumulator and is rounded toward zero (rz32)."""
    steps = a.shape[-1] // 16
    drop = (1 << 29) - 1  # the mantissa bits float64 has beyond fp32's 23
    sums = (a.double().unflatten(-1, (steps, 16)).movedim(-2, 0)
            @ b.double().unflatten(-2, (steps, 16)).movedim(-3, 0))
    c = torch.as_tensor(c, dtype=torch.float32)
    # fast: the accumulator stays float64, each step's sum truncated in
    # place to fp32's 24 bits (rz32 wherever the sums stay in fp32's normal
    # range, as an accumulator's do); a result outside it takes rz32 step
    # by step
    acc = c.double() + sums[0]
    for i in range(steps):
        if i:
            acc.add_(sums[i])
        acc.view(torch.int64).bitwise_and_(~drop)
    out = acc.float()
    if (((out.abs() < 2.0 ** -126) & (out != 0)) | out.isinf()).any():
        out = c
        for i in range(steps):
            out = rz32(out.double() + sums[i])
    return out


# -- wgmma's rounding ---------------------------------------------------------
# What the card's warpgroup product does, as `rdeic_torch/tools/wgmma_probe.py`
# reads it (bf16 m64n64k16 and tf32 m64n64k8, NVIDIA H100 80GB HBM3;
# `tests/test_torch_port_cuda.py` holds the card to these constants): an fp32
# operand read as TF32 loses its 13 low bits (truncation, as `tf32_truncate`);
# each instruction aligns its products and the accumulator C to the largest
# of them, cuts every term toward zero to WGMMA_GUARD_BITS bits below that
# term's fp32 ulp (a product 2^-3 ulp of it below is lost, 2^-2 is kept),
# adds the cut terms exactly and rounds the sum toward zero (WGMMA_ROUNDING),
# so a tie rounds toward zero too.
WGMMA_ROUNDING = "rz"
WGMMA_GUARD_BITS = 2


def _wgmma_chain_jax():
    """The jitted chain of `wgmma_chain`: XLA fuses each instruction's
    products, cut and sum into one pass, which torch's elementwise ops take
    ten (JAX is imported here, so that the card's tests can import this
    module where JAX is absent)."""
    import jax
    import jax.numpy as jnp

    def step(c, ab):
        a, b = ab  # [.., M, k], [.., k, N]
        p = a[..., :, None, :] * jnp.swapaxes(b, -1, -2)[..., None, :, :]
        mx = jnp.maximum(jnp.max(jnp.abs(p), -1), jnp.abs(c))
        _, e = jnp.frexp(mx)  # mx < 2^e: its fp32 ulp is 2^(e - 24)
        # 1 / the cut; capped where every term is below 2^-100 (the cut
        # there is below any fp32 sum the kernels keep)
        inv_q = jnp.ldexp(jnp.float32(1), jnp.minimum(
            24 + WGMMA_GUARD_BITS - e, 126))
        # each term in units of the cut, toward zero: exact integers under
        # 2^26, so a sum of 17 fits int32
        n = (jnp.sum((p * inv_q[..., None]).astype(jnp.int32), -1)
             + (c * inv_q).astype(jnp.int32))
        # rounded toward zero to fp32's 24 significant bits
        m = jnp.abs(n).astype(jnp.uint32)
        bits = 32 - jax.lax.clz(m).astype(jnp.int32)
        shift = jnp.maximum(bits - 24, 0).astype(jnp.uint32)
        m = (m >> shift) << shift
        return jnp.sign(n).astype(jnp.float32) * m.astype(jnp.float32) / inv_q, None

    def chain(c, a, b):  # a [n, .., M, k], b [n, .., k, N]: n instructions
        return jax.lax.scan(step, c, (a, b))[0]

    return jax.jit(chain)


_CHAIN = []


def wgmma_chain(c, a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """c [.., M, N] plus a [.., M, K] @ b [.., K, N] as K / k wgmma
    instructions in order (instruction i takes the k-slice i of a and b;
    their products exact in fp32: bf16 or TF32 values), each by the model
    above: the terms and the accumulator aligned to the largest, cut toward
    zero WGMMA_GUARD_BITS bits below its ulp, added exactly, the sum rounded
    toward zero."""
    import jax.numpy as jnp

    if not _CHAIN:
        _CHAIN.append(_wgmma_chain_jax())
    n = a.shape[-1] // k
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.float().expand(*shape, *a.shape[-2:])
    b = b.float().expand(*shape, *b.shape[-2:])
    c = torch.as_tensor(c, dtype=torch.float32).expand(
        *shape, a.shape[-2], b.shape[-1])
    a_steps = a.unflatten(-1, (n, k)).movedim(-2, 0)  # [n, .., M, k]
    b_steps = b.unflatten(-2, (n, k)).movedim(-3, 0)  # [n, .., k, N]
    out = _CHAIN[0](*(jnp.asarray(x.contiguous().numpy())
                      for x in (c, a_steps, b_steps)))
    return torch.from_numpy(np.array(out))


def wgmma_bf16(a: torch.Tensor, b: torch.Tensor, c=0.0) -> torch.Tensor:
    """c + a @ b as 16-deep bf16 wgmma steps (a and b hold bf16 values)."""
    return wgmma_chain(c, a, b, 16)


def wgmma_3xtf32(a: torch.Tensor, b: torch.Tensor, c=0.0) -> torch.Tensor:
    """c + a @ b as the d = 64 fp32 forward takes it: per 8-deep step three
    wgmma instructions, small * big, big * small, big * big (big rounded to
    TF32 to nearest by the kernel, small = x - big as the tensor core reads
    it: truncated)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    n = a.shape[-1] // 8
    # the instructions' operands in their order, 8 deep each
    a_seq = torch.stack([x.unflatten(-1, (n, 8)) for x in (as_, ab, ab)],
                        -2).flatten(-3)
    b_seq = torch.stack([x.unflatten(-2, (n, 8)) for x in (bb, bs, bb)],
                        -3).flatten(-4, -2)
    return wgmma_chain(c, a_seq, b_seq, 8)


def wgmma_tf32(a: torch.Tensor, b: torch.Tensor, c=0.0) -> torch.Tensor:
    """c + a @ b in one TF32 wgmma pass a step: fp32 operands as the tensor
    core reads them (truncated)."""
    return wgmma_chain(c, tf32_truncate(a), tf32_truncate(b), 8)


# -- the 128-byte swizzle of the Hopper tiles --------------------------------
def swizzle128(r: int, b: int) -> int:
    """flash_hopper.cuh `swizzle128`: the byte of (row r, byte b) in a
    128-byte-swizzled atom (16-byte chunk c of row r at chunk c ^ (r & 7))."""
    return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15)


def wgmma_reads(start: int, row: int, byte: int, row_bytes: int = 128) -> int:
    """The shared-memory byte that `wgmma` reads for (row, byte) of an
    operand whose descriptor starts at `start` (1024-aligned atoms plus the
    step's offset): the canonical address, rows `row_bytes` apart and
    groups of 8 rows 8 `row_bytes` apart (the stride byte offset), with
    address bits 4.. XOR-ed by bits 7.. (layout type 1, the 128-byte
    swizzle: 3 bits; 2, the 64-byte: 2; 3, the 32-byte: 1). For a K-major
    operand a row is an M or N index and `byte` runs along K; for an
    MN-major one a row is a K index and `byte` runs along MN."""
    a = start + (row // 8) * 8 * row_bytes + (row % 8) * row_bytes + byte
    return a ^ (((a >> 7) & (row_bytes // 16 - 1)) << 4)


def swizzled(a: int, row_bytes: int) -> int:
    """flash_hopper.cuh `swizzled`: where a 1024-aligned tile of
    `row_bytes`-wide rows keeps the byte of dense offset `a` (TMA's 128-,
    64- and 32-byte swizzles)."""
    return a ^ (((a >> 7) & (row_bytes // 16 - 1)) << 4)


# -- the d = 64 backward's streamed tiles --------------------------------------
D64 = 64
# rows L is padded to (any multiple of KC: each row's sums are its own) and
# the streamed rows a tile (flash_attn_bwd.cu d64::BN)
BT, KC = 64, 32


def d64_inputs(b, seq, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, D64)).astype(np.float32))
            for _ in range(3)]


def backward_d64_tiles(q, k, v, o, lse, do, mm, acc=None):
    """(dq, dk, dv) over 32-row streamed tiles, as `flash_dq_d64` and
    `flash_dkv_d64` take them, every product by mm, and `acc(x, a, b)`
    (default x + mm(a, b)) taking each tile's products into the
    accumulators dq, dk and dv. L is padded to 64 rows with zero rows; rows
    are independent, so the kept tiles are one batch dimension here.
    dq: each q row's lse comes from the forward, its di = rowsum(dO O) from
    its own dO and O; K and V stream in 32-key chunks: S = mm(Q, K^T),
    P = exp(S scale - lse) (0 on a padded row or key), dP = mm(dO, V^T),
    dS = P (dP - di) scale, dq += mm(dS, K). dkv: each key row streams Q and
    dO in 32-row chunks, lse and di by column (di from the dq pass):
    S^T = mm(K, Q^T), P^T = exp(S^T scale - lse) (0 on a padded q row),
    dP^T = mm(V, dO^T), dS^T = P^T (dP^T - di) scale, dv += mm(P^T, dO),
    dk += mm(dS^T, Q)."""
    if acc is None:
        def acc(x, a, b):
            return x + mm(a, b)
    b, seq, h, d = q.shape
    scale = d ** -0.5
    pad = -seq % BT
    qh, kh, vh, oh, doh = (
        torch.nn.functional.pad(x.permute(0, 2, 1, 3), (0, 0, 0, pad))
        for x in (q, k, v, o, do))  # [B, H, Lp, D]
    rows = torch.arange(seq + pad)
    valid = rows < seq
    lse_p = torch.nn.functional.pad(lse.reshape(b, h, seq), (0, pad))
    di = (doh * oh).sum(-1)  # [B, H, Lp]: 0 on the padded rows
    zero = torch.zeros((), dtype=q.dtype)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for c0 in range(0, seq + pad, KC):
        cols = slice(c0, c0 + KC)
        # dq: every q row against keys c0.. (chunks of the streamed K / V)
        s = mm(qh, kh[:, :, cols].transpose(-1, -2))
        mask = valid[:, None] & valid[cols][None, :]
        p = torch.where(mask, torch.exp(s * scale - lse_p[..., None]), zero)
        ds = p * (mm(doh, vh[:, :, cols].transpose(-1, -2)) - di[..., None]) * scale
        dq = acc(dq, ds, kh[:, :, cols])
        # dkv: every key row against q rows c0.. (chunks of the streamed Q / dO)
        st = mm(kh, qh[:, :, cols].transpose(-1, -2))
        pt = torch.where(valid[cols][None, :],
                         torch.exp(st * scale - lse_p[..., None, cols]), zero)
        dpt = mm(vh, doh[:, :, cols].transpose(-1, -2))
        dst = pt * (dpt - di[..., None, cols]) * scale
        dv = acc(dv, pt, doh[:, :, cols])
        dk = acc(dk, dst, qh[:, :, cols])
    return tuple(x[:, :, :seq].permute(0, 2, 1, 3) for x in (dq, dk, dv))


def d64_bwd_inputs(b, seq, h, seed):
    """fp32 q, k, v, dO, and the float64 forward's o and lse rounded to
    fp32 (the backward kernels start from the forward's)."""
    q, k, v = d64_inputs(b, seq, h, seed)
    rng = np.random.default_rng(seed + 100)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    o, lse = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    return q, k, v, o.float(), lse.float(), do


def rel(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


# -- shared-memory banks -----------------------------------------------------
def banks(addrs) -> list:
    """The 4-byte banks (of 32) that float addresses fall on."""
    return [a % 32 for a in addrs]


def ldmatrix_phases(stride, swizzle=False, rows=BT):
    """Each 8-row matrix of one ldmatrix.x4 (RowA and RowB of flash_mma.cuh
    at a corner of multiples of 8): its 8 lanes' 16-byte rows, as the float
    addresses they cover, for every corner row a warp uses of a tile of
    `rows` rows."""
    for r0 in range(0, rows, 8):
        for c in (0, 4):
            addrs = []
            for r in range(r0, r0 + 8):
                col = c ^ (r & 4) if swizzle else c
                addrs += [r * stride + col + j for j in range(4)]
            yield addrs
