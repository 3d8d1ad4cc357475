"""`python -m rdeic_torch.experiments.run_robustness` against the root
experiments/run_robustness.py on the CPU, at the micro config with the same
random weights and LPIPS weights.

The root script runs on the test's JAX model; its noise is one
`jax.random.split` of PRNGKey(0) a row, failed rows included, and the
port's `sweep_image` is handed the same draws as `noise()`. The corrupted
streams are the same bytes (the same seeds). Limits: the clean stream, the
rows' keys, bpp and `decode_failed` equal; each metric of a decoded row
within tests/torch_port_harness.py's METRIC_TOL of the root CSV's."""
import struct

import numpy as np
import pytest
import torch

from rdeic_torch.experiments import run_robustness as t_rob
from rdeic_torch.utils.image import pad, read_rgb, to_float01, to_uint8
from tests.torch_port_harness import (
    STEPS, check_metrics, jax_noise, read_csv, run_root, save_images, suites)
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    micro_pair, one_torch_thread_per_module)

HW = (49, 77)  # pads to 64x128
LATENT = (1, 32, 64, 4)
SEEDS, RATES, SEVERITIES = [0, 1], [0.0, 0.002, 0.3], [0.0, 0.3]
TARGETS = ["bitstream:random", "latent:additive"]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("robustness")
    jm, params, tm = micro_pair(seed=7)
    (image,) = save_images(tmp / "imgs", [HW], seed=8)
    js, ts = suites(seed=9)
    run_root("experiments.run_robustness", [
        "--ckpt", "unused.npz", "--input", str(image), "--output",
        str(tmp / "jax"), "--seeds", *map(str, SEEDS), "--error_rates",
        *map(str, RATES), "--targets", *TARGETS, "--latent_severities",
        *map(str, SEVERITIES)], jm, params, js)
    fns = {n: ts.create_metric(n) for n in t_rob.METRICS}
    out_dir = tmp / "torch"
    out_dir.mkdir()
    pairs = list(t_rob.sweep_image(
        tm, read_rgb(image), "im0", out_dir / "im0.rdeic",
        out_dir / "_corrupt.rdeic", TARGETS, RATES, SEVERITIES, SEEDS, STEPS,
        fns, jax_noise(0, LATENT)))
    rows = [r for r, _ in pairs]
    return dict(tmp=tmp, tm=tm, rows=rows, recons=[x for _, x in pairs],
                summary=t_rob.write_results(out_dir, rows), out_dir=out_dir)


def test_rows_match_the_root_script(sweep):
    tmp = sweep["tmp"]
    header, want = read_csv(tmp / "jax" / "robustness_results.csv")
    got_header, got = read_csv(sweep["out_dir"] / "robustness_results.csv")
    assert got_header == header == sorted(header)
    assert "error" in header and len(got) == len(want) == 10
    assert ((tmp / "jax" / "streams" / "im0.rdeic").read_bytes()
            == (sweep["out_dir"] / "im0.rdeic").read_bytes())
    failed = [w["decode_failed"] == "True" for w in want]
    assert any(failed) and not all(failed)  # the 0.3 rate fails, 0 never
    for g, w in zip(got, want):
        for k in ("image", "target", "mode", "severity", "seed", "bpp",
                  "decode_failed"):
            assert g[k] == w[k], k
        assert bool(g["error"]) == bool(w["error"])
        assert len(g["error"]) <= 200
        check_metrics(g, w, t_rob.METRICS)


def test_summary_matches_the_root_script(sweep):
    header, want = read_csv(sweep["tmp"] / "jax" / "robustness_summary.csv")
    got_header, got = read_csv(sweep["out_dir"] / "robustness_summary.csv")
    assert got_header == header == ["target", "mode", "severity", "n",
                                    "fail_rate", "psnr", "ms_ssim", "lpips"]
    assert len(got) == len(want) == len(sweep["summary"]) == 5
    for g, w in zip(got, want):
        for k in ("target", "mode", "severity", "n", "fail_rate"):
            assert g[k] == w[k], k
        check_metrics(g, w, t_rob.METRICS)


def test_clean_rows_are_the_clean_decode(sweep):
    """Severity 0 of either target decodes the clean stream: its image is
    decode_pipeline's of that stream with the row's noise; a failed row
    gives no image."""
    tm = sweep["tm"]
    c_latent, hint = tm.apply_condition_decompress(
        sweep["out_dir"] / "im0.rdeic")
    noise = jax_noise(0, LATENT)
    for row, recon in zip(sweep["rows"], sweep["recons"]):
        kw = noise()
        assert (recon is None) == row["decode_failed"]
        if row["severity"] == 0:
            want = tm.decode_pipeline(c_latent, hint, STEPS, **kw)[0].numpy()
            np.testing.assert_array_equal(recon, to_uint8(want)[:HW[0], :HW[1]])


@pytest.mark.parametrize("shared", ["1", "0"], ids=["v2", "v1"])
def test_corrupt_lane_streams_raise_or_decode(sweep, tmp_path, monkeypatch,
                                              shared):
    """On the lane route (K = 32, decoded by the plain versions of the lane
    kernels here) corrupted payloads either raise, as `sweep_image` records
    them, or decode to latents of the clean shape; the clean stream then
    decodes as before, bit for bit."""
    from rdeic_torch.experiments.corruptors import Corruptor  # noqa: PLC0415

    tm = sweep["tm"]
    for key, value in {"RDEIC_RANS_LANES": "32", "RDEIC_RANS_SHARED": shared,
                       "RDEIC_RANS_OVERHEAD_PCT": "0"}.items():
        monkeypatch.setenv(key, value)
    tm._codec = None  # built anew under these settings
    try:
        arr = read_rgb(sweep["tmp"] / "imgs" / "im0.png")
        img01 = torch.from_numpy(to_float01(pad(arr, 64))[None])
        clean = tmp_path / "clean.rdeic"
        tm.apply_condition_compress(img01, clean, *img01.shape[1:3])
        want = tm.apply_condition_decompress(clean)
        raw, outcomes = clean.read_bytes(), []
        for rate in (1e-3, 1e-2, 1e-1):
            for seed in range(3):
                bad = tmp_path / "bad.rdeic"
                bad.write_bytes(raw[:12] + Corruptor(
                    "bitstream", "random", rate, seed).apply_bytes(raw[12:]))
                try:
                    c_latent, _ = tm.apply_condition_decompress(bad)
                    assert c_latent.shape == want[0].shape
                    outcomes.append("decoded")
                except (ValueError, OverflowError, struct.error) as e:
                    outcomes.append(type(e).__name__)
        assert "decoded" in outcomes and set(outcomes) != {"decoded"}
        got = tm.apply_condition_decompress(clean)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        tm._codec = None
