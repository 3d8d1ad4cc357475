"""The interleaved-lane rANS of rdeic_torch against rdeic_tpu's on the CPU:
the host coder's interleaved and shared-stream bindings byte for byte, and
the plain versions of `decode_pass`, `decode_pass_shared` and
`encode_lanes` (the kernels' references) symbol for symbol and word for
word against the JAX functions (run on the CPU as tests/test_device_rans.py
and tests/test_shared_rans.py run them) and the host coder: K of 4, 7 and
128, with and without escapes, batched, and on corrupt streams. Also the
shared-stream kernel's two-level lane count (a warp ballot, then the lower
warps' totals) emulated in NumPy against the exclusive cumsum it
replaces."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.entropy import coder as tc
from rdeic_torch.entropy import device_rans as td
from rdeic_torch.ops import gaussian as tg
from rdeic_tpu.entropy import coder as jc
from rdeic_tpu.entropy import device_rans as jd
from rdeic_tpu.ops import gaussian as jg
from tests.torch_port_helpers import one_torch_thread_per_module  # noqa: F401
from tests.torch_port_rans import decode_passes, lane_batch, random_case

SIZES = [257, 64, 40, 33]


@pytest.fixture(scope="module")
def tables():
    jt = jc.CdfTable(*jg.build_cdf_tables(jg.get_scale_table()))
    tt = tc.CdfTable(*tg.build_cdf_tables(tg.get_scale_table()))
    return jt, tt, jd.DeviceRansTables(jt), td.DeviceRansTables(tt)


def _cases(table, b, esc, seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [random_case(table, rng, sizes, esc) for _ in range(b)]


def _flat(case):
    syms, idxs = case
    return np.concatenate(syms), np.concatenate(idxs), [s.size for s in syms]


# -- the host coder's bindings -------------------------------------------------
def test_lut_is_the_jax_packages(tables):
    jt, tt, _, _ = tables
    np.testing.assert_array_equal(tt.lut(), jt.lut())
    assert tt.lut().shape == (64 * 65536,) and tt.lut().dtype == np.uint16


@pytest.mark.parametrize("k,esc", [(2, 0.0), (7, 0.15), (16, 0.1), (128, 0.05)])
def test_interleaved_bindings_are_byte_equal(tables, k, esc):
    jt, tt, _, _ = tables
    s, ix, sizes = _flat(_cases(tt, 1, esc, seed=k)[0])
    v1 = tc.rans_encode_interleaved(s, ix, sizes, k, tt)
    want = jc.rans_encode_interleaved(s, ix, sizes, k, jt)
    assert v1[0] == want[0]
    np.testing.assert_array_equal(v1[1], want[1])
    v2 = tc.rans_encode_interleaved_shared(s, ix, sizes, k, tt)
    assert v2 == jc.rans_encode_interleaved_shared(s, ix, sizes, k, jt)
    assert v2 == tc.rans_lanes_to_shared(*v1, ix, sizes, tt)
    assert len(v2) == int(v1[1].sum())  # the same words, merged
    with tc.SharedRansDecoder(v2, k) as dec:
        jdec = jc.SharedRansDecoder(v2, k)
        for p, n in enumerate(sizes):
            lo = sum(sizes[:p])
            got = dec.decode_pass(ix[lo:lo + n], tt)
            np.testing.assert_array_equal(got, jdec.decode_pass(ix[lo:lo + n], jt))
            np.testing.assert_array_equal(got, s[lo:lo + n])
        jdec.close()


def test_binding_errors(tables):
    _, tt, _, _ = tables
    with pytest.raises(ValueError, match="sum to the symbol count"):
        tc.rans_encode_interleaved(np.zeros(3), np.zeros(3), [2], 4, tt)
    with pytest.raises(ValueError, match="length mismatch"):
        tc.rans_encode_interleaved_shared(np.zeros(3), np.zeros(2), [3], 4, tt)
    dec = tc.SharedRansDecoder(b"\0" * 8, 2)
    dec.close()
    with pytest.raises(RuntimeError, match="closed"):
        dec.decode_pass(np.zeros(2), tt)


# -- host helpers and state ------------------------------------------------------
def test_host_helpers_and_state_are_the_jax_packages(tables):
    _, tt, _, _ = tables
    s, ix, sizes = _flat(_cases(tt, 1, 0.1, seed=3)[0])
    payload, nbytes = tc.rans_encode_interleaved(s, ix, sizes, 7, tt)
    words, nw = td.lanes_from_bytes(payload, nbytes)
    jwords, jnw = jd.lanes_from_bytes(payload, nbytes)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(nw, jnw)
    state, ptr = td.init_lane_state(torch.from_numpy(words.astype(np.int32)),
                                    torch.from_numpy(nw))
    jstate, jptr = jd.init_lane_state(jnp.asarray(jwords), jnp.asarray(jnw))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jptr))
    shared = tc.rans_encode_interleaved_shared(s, ix, sizes, 7, tt)
    sw, n = td.shared_words_from_bytes(shared + b"\7")  # an odd tail byte
    jsw, jn = jd.shared_words_from_bytes(shared + b"\7")
    np.testing.assert_array_equal(sw, jsw)
    assert n == jn
    for cut in (n, 5):  # a stream shorter than its 2K head words reads 0
        state, ptr = td.init_shared_state(
            torch.from_numpy(sw.astype(np.int32))[None],
            torch.tensor([cut], dtype=torch.int32), 7)
        jstate, jptr = jd.init_shared_state(
            jnp.asarray(sw)[None], jnp.asarray([cut], jnp.int32), 7)
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
        np.testing.assert_array_equal(ptr.numpy(), np.asarray(jptr))
    for k in (3, 4):
        got = td.pad_pass_indexes(ix[:10], k)
        want = jd.pad_pass_indexes(ix[:10], k)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# -- decode: plain versions against JAX and the host coder ----------------------
def _jax_decode(jtabs, words, nwords, k, idxs_by_pass, shared):
    words, nwords = jnp.asarray(words.numpy()), jnp.asarray(nwords.numpy())
    if shared:
        state = jd.init_shared_state(words, nwords, k)
        fn = jd.decode_pass_shared
    else:
        state = jd.init_lane_state(words, nwords)
        fn = jd.decode_pass
    out = []
    for idx in idxs_by_pass:
        padded, n = td.pad_pass_indexes(idx, k)
        sym, state = fn(jtabs, words, nwords, *state, jnp.asarray(padded), n)
        out.append((np.asarray(sym)[:, :n], np.asarray(state[0]),
                    np.asarray(state[1])))
    return out


@pytest.mark.parametrize("shared", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("k,esc,b", [(4, 0.0, 1), (4, 0.05, 2), (7, 0.02, 1),
                                     (128, 0.1, 2)])
def test_plain_decode_matches_jax_and_the_host(tables, k, esc, b, shared):
    _, tt, jtabs, ttabs = tables
    cases = _cases(tt, b, esc, seed=10 * k + b)
    words, nwords = lane_batch(tt, k, cases, shared)
    idxs = [np.stack([c[1][p] for c in cases]) for p in range(len(SIZES))]
    got = decode_passes(ttabs, words, nwords, k, idxs, shared)
    want = _jax_decode(jtabs, words, nwords, k, idxs, shared)
    for p, ((sym, state, ptr), (jsym, jstate, jptr)) in enumerate(
            zip(got, want)):
        np.testing.assert_array_equal(sym.numpy(), jsym)
        np.testing.assert_array_equal(state.numpy(), jstate)
        np.testing.assert_array_equal(ptr.numpy(), jptr)
        for i, (syms, _) in enumerate(cases):
            np.testing.assert_array_equal(sym[i].numpy(), syms[p])


@pytest.mark.parametrize("shared", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("k", [4, 128])
def test_plain_decode_of_corrupt_streams_is_the_jax_packages(tables, k, shared):
    """Garbage words, and a stream cut short: the JAX package's symbols,
    every gather clamped, and nothing raised."""
    _, tt, jtabs, ttabs = tables
    cases = _cases(tt, 2, 0.1, seed=k + 7)
    words, nwords = lane_batch(tt, k, cases, shared)
    rng = np.random.default_rng(k)
    words = torch.from_numpy(rng.integers(0, 1 << 16, tuple(words.shape),
                                          dtype=np.int32))
    nwords = nwords // 2 + 1
    idxs = [np.stack([c[1][p] for c in cases]) for p in range(len(SIZES))]
    got = decode_passes(ttabs, words, nwords, k, idxs, shared)
    want = _jax_decode(jtabs, words, nwords, k, idxs, shared)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("k", [2, 7, 32, 33, 128])
def test_two_level_lane_count_is_the_exclusive_cumsum(k):
    """rans_decode_shared's count of lower lanes pulling: within a warp,
    __popc of the ballot's bits below the lane; across warps, the totals
    of the lower warps (threads past K pull nothing); the cursor moves by
    the block's total."""
    rng = np.random.default_rng(k)
    threads = -(-k // 32) * 32
    for _ in range(20):
        pull = np.zeros(threads, bool)
        pull[:k] = rng.random(k) < rng.random()
        ballots = [sum(1 << j for j in range(32) if pull[w * 32 + j])
                   for w in range(threads // 32)]
        counts = [bin(m).count("1") for m in ballots]
        offs = np.array([
            bin(ballots[t // 32] & ((1 << (t % 32)) - 1)).count("1")
            + sum(counts[:t // 32]) for t in range(threads)])
        pc = pull[:k].astype(np.int64)
        np.testing.assert_array_equal(offs[:k], np.cumsum(pc) - pc)
        assert sum(counts) == pc.sum()


# -- encode ----------------------------------------------------------------------
def _steps(cases, k):
    syms = [torch.from_numpy(np.stack([c[0][p] for c in cases]))
            for p in range(len(SIZES))]
    idxs = [torch.from_numpy(np.stack([c[1][p] for c in cases]))
            for p in range(len(SIZES))]
    return td.build_pass_steps(syms, idxs, k), (
        jd.build_pass_steps([jnp.asarray(s.numpy()) for s in syms],
                            [jnp.asarray(i.numpy()) for i in idxs], k))


@pytest.mark.parametrize("k,esc,b", [(4, 0.0, 1), (4, 0.08, 3), (7, 0.02, 2),
                                     (128, 0.05, 2)])
def test_plain_encode_matches_jax_and_the_host(tables, k, esc, b):
    jt, tt, jtabs, ttabs = tables
    cases = _cases(tt, b, esc, seed=11 + k + b)
    steps, jsteps = _steps(cases, k)
    for a, w in zip(steps, jsteps):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    wcap = max(64, 4 * steps[0].shape[0])
    words, nwords, ovf = td.encode_lanes(ttabs, *steps, wcap)
    jwords, jnwords, jovf = jd.encode_lanes(jtabs, *jsteps, wcap)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    np.testing.assert_array_equal(nwords.numpy(), np.asarray(jnwords))
    assert not bool(ovf) and not bool(jovf)
    for i, case in enumerate(cases):
        payload, nbytes = td.assemble_lane_payloads(words[i].numpy(),
                                                    nwords[i].numpy())
        jpayload, jnbytes = jd.assemble_lane_payloads(
            np.asarray(jwords)[i], np.asarray(jnwords)[i])
        assert payload == jpayload
        host = tc.rans_encode_interleaved(*_flat(case), k, tt)
        assert payload == host[0]
        np.testing.assert_array_equal(nbytes, host[1])
        np.testing.assert_array_equal(nbytes, jnbytes)


def test_plain_encode_overflow_is_the_jax_packages(tables):
    """Too few words a lane (the words the JAX package keeps up to the
    capacity, and the flag), and an escape payload past 2^18."""
    _, tt, jtabs, ttabs = tables
    cases = _cases(tt, 2, 0.0, seed=5, sizes=[256])
    syms = [torch.from_numpy(np.stack([c[0][0] for c in cases]))]
    idxs = [torch.from_numpy(np.stack([c[1][0] for c in cases]))]
    for s, ix, wcap in ((syms, idxs, 4),
                        ([torch.tensor([[10_000_000]], dtype=torch.int32)],
                         [torch.zeros((1, 1), dtype=torch.int32)], 64)):
        steps = td.build_pass_steps(s, ix, 2)
        jsteps = jd.build_pass_steps([jnp.asarray(t.numpy()) for t in s],
                                     [jnp.asarray(t.numpy()) for t in ix], 2)
        got = td.encode_lanes(ttabs, *steps, wcap)
        want = jd.encode_lanes(jtabs, *jsteps, wcap)
        assert bool(got[2]) and bool(want[2])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_plain_versions_refuse_cuda_tensors_and_wrappers_count_nothing(tables):
    _, tt, _, ttabs = tables
    before = (td.decode_pass.launches, td.decode_pass_shared.launches,
              td.encode_lanes.launches)
    cases = _cases(tt, 1, 0.0, seed=1)
    words, nwords = lane_batch(tt, 4, cases, False)
    decode_passes(ttabs, words, nwords, 4, [cases[0][1][0][None]], False)
    assert (td.decode_pass.launches, td.decode_pass_shared.launches,
            td.encode_lanes.launches) == before
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        td.decode_pass(ttabs, words.to("meta"), nwords, *td.init_lane_state(
            words, nwords), torch.zeros((1, 4), dtype=torch.int32), 4)
