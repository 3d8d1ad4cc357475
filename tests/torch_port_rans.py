"""Cases of the interleaved-lane rANS tests: random symbols and CDF indexes
per pass (the recipe of tests/test_device_rans.py `_random_case`), and
their lanes stacked into the batched words the kernels read. No JAX here:
the card tests import it too."""
import numpy as np
import torch

from rdeic_torch.entropy import device_rans as dr
from rdeic_torch.entropy.coder import (
    rans_encode_interleaved,
    rans_encode_interleaved_shared,
)


def random_case(table, rng, sizes, esc_frac=0.0):
    """(symbols, indexes) per pass of `sizes`; esc_frac of the symbols are
    forced out of their CDF's range (bypass escapes)."""
    syms, idxs = [], []
    for n in sizes:
        idx = rng.integers(0, table.ncdfs, n).astype(np.int32)
        max_v = table.length[idx] - 2
        off = table.offset[idx]
        v = (off + rng.integers(0, 1 << 30) % np.maximum(max_v, 1)).astype(
            np.int32)
        if esc_frac:
            esc = rng.random(n) < esc_frac
            v = np.where(esc, rng.integers(-3000, 3000, n).astype(np.int32), v)
        syms.append(v)
        idxs.append(idx)
    return syms, idxs


def lane_batch(table, k, cases, shared: bool):
    """Encode each (symbols, indexes) case at K lanes and stack the images'
    words as the codec does: v1 ([B, K, W], nwords [B, K]) or v2 shared
    ([B, W], nwords [B]), W padded; int32 CPU tensors."""
    if shared:
        mats = [dr.shared_words_from_bytes(rans_encode_interleaved_shared(
            np.concatenate(s), np.concatenate(ix), [x.size for x in s], k,
            table)) for s, ix in cases]
        words = np.zeros((len(cases), max(m[1] for m in mats) + 3), np.int32)
        nwords = np.zeros(len(cases), np.int32)
        for i, (w, nw) in enumerate(mats):
            words[i, :w.shape[0]] = w
            nwords[i] = nw
    else:
        mats = [dr.lanes_from_bytes(*rans_encode_interleaved(
            np.concatenate(s), np.concatenate(ix), [x.size for x in s], k,
            table)) for s, ix in cases]
        words = np.zeros((len(cases), k, max(m[0].shape[1] for m in mats) + 3),
                         np.int32)
        nwords = np.zeros((len(cases), k), np.int32)
        for i, (w, nw) in enumerate(mats):
            words[i, :, :w.shape[1]] = w
            nwords[i] = nw
    return torch.from_numpy(words), torch.from_numpy(nwords)


def decode_passes(tabs, words, nwords, k, idxs_by_pass, shared: bool):
    """Every pass through `decode_pass` (v1) or `decode_pass_shared` (v2) on
    the tensors' device: [(symbols [B, n] int32 on the CPU, state, ptr)]."""
    if shared:
        state = dr.init_shared_state(words, nwords, k)
        fn = dr.decode_pass_shared
    else:
        state = dr.init_lane_state(words, nwords)
        fn = dr.decode_pass
    out = []
    for idx in idxs_by_pass:  # [B, n] int32 numpy
        padded, n = dr.pad_pass_indexes(idx, k)
        sym, state = fn(tabs, words, nwords, *state,
                        torch.from_numpy(padded).to(words.device), n)
        out.append((sym.cpu()[:, :n], state[0].cpu(), state[1].cpu()))
    return out
