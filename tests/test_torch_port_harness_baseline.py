"""`python -m rdeic_torch.baseline_inference` and `rdeic_torch.image_checker`
against the root baseline_inference.py and image_checker.py on the CPU, at
the micro config with the same random weights, on two images that pad to
64x128 (MS-SSIM, defined from 176 px, reads NaN in both).

The root script draws its noise from `jax.random.split` of PRNGKey(--seed)
once per image; `process_single` is handed those draws. Both suites score
LPIPS with the same random weights, carried from the JAX net. Limits:
streams and bpp equal; the reconstruction before `to_uint8` within ATOL
(2e-4, the port's fp32 parity), so the saved images within one level;
the row's metrics within tests/torch_port_harness.py's METRIC_TOL of the
root CSV's; the port's metric code on the root script's own images within
1e-5, as tests/test_torch_port_metrics.py holds it.

The streams are equal where no y - mu the codec rounds lies within the two
packages' fp32 disagreement (~1e-5: convolutions summed in another order)
of a rounding edge; the test reads that margin on these inputs. (At
192x192, 1152 symbols an image, one of two images had a symbol at such an
edge: its streams differed by 2 bytes.)
"""
import jax
import numpy as np
import pytest
import torch

from rdeic_torch import baseline_inference as t_baseline
from rdeic_torch import image_checker as t_checker
from rdeic_torch.utils.image import pad, read_rgb, to_float01, to_uint8
from rdeic_torch.utils.metrics import score_images
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_harness import (
    check_metrics, read_csv, run_root, save_images, suites)
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    ATOL, MICRO, micro_pair, one_torch_thread_per_module, random_flat_params)

SIZES = [(49, 77), (60, 100)]
SEED, STEPS = 231, 2  # the root script's defaults
LATENT = (1, 32, 64, 4)  # the micro VAE halves 64x128
MARGIN = 1e-5  # y - mu from a rounding edge: the fp32 disagreement
COLUMNS = ["name", "bpp", "enc_time", "dec_time", "psnr", "ssim", "ms_ssim",
           "lpips"]


def rounding_margin(model, arr: np.ndarray) -> float:
    """The smallest distance from a rounding edge of the values the port's
    codec rounds to symbols (y - mu) when it codes `arr` padded as the
    harness pads it."""
    img01 = torch.from_numpy(to_float01(pad(arr, 64))[None])
    real, seen = torch.round, []

    def spy(x, *args, **kwargs):
        seen.append((0.5 - (x - real(x)).abs()).min().item())
        return real(x, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "round", spy)
        model.codec().compress(model.feature(img01))
    return min(seen)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    yaml = pytest.importorskip("yaml")
    tmp = tmp_path_factory.mktemp("baseline")
    jm, params, tm = micro_pair(seed=3)
    np.savez(tmp / "p.npz", **random_flat_params(jm, (64, 64), seed=3))
    (tmp / "m.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    save_images(tmp / "imgs", SIZES, seed=4)
    js, ts = suites(seed=5)
    run_root("baseline_inference", [
        "--ckpt", str(tmp / "p.npz"), "--input", str(tmp / "imgs"),
        "--output", str(tmp / "jax"), "--num_images", "2"], jm, params, js)

    fns = {n: ts.create_metric(n) for n in t_baseline.METRICS}
    key = jax.random.PRNGKey(SEED)
    (tmp / "torch" / "bitstreams").mkdir(parents=True)
    out = {"rows": [], "out01": [], "want01": [], "refs": [], "margins": []}
    for i, hw in enumerate(SIZES):
        key, sub = jax.random.split(key)
        relay, steps = _jax_noise(sub, LATENT, STEPS)
        ref = read_rgb(tmp / "imgs" / f"im{i}.png")
        out["margins"].append(rounding_margin(tm, ref))
        out01, bpp, enc_t, dec_t = t_baseline.process_single(
            tm, ref, tmp / "torch" / "bitstreams" / f"im{i}.rdeic", STEPS,
            relay_noise=relay, step_noise=steps)
        out["rows"].append(t_baseline.baseline_row(
            f"im{i}", bpp, enc_t, dec_t,
            score_images(fns, ref, to_uint8(out01), "cpu")))
        out["out01"].append(out01)
        out["refs"].append(ref)
        # the root script's reconstruction before to_uint8, from its stream
        c_latent, hint = jm.apply_condition_decompress(
            params, str(tmp / "jax" / "bitstreams" / f"im{i}.rdeic"))
        want = jm.jitted_decode(steps=STEPS)(params, c_latent, hint, sub)
        out["want01"].append(np.asarray(want)[0][:hw[0], :hw[1]])
    t_baseline.write_csv(tmp / "torch" / "baseline_metrics.csv", out["rows"])
    return dict(tmp=tmp, ts=ts, js=js, **out)


def test_streams_and_bpp_equal_the_root_script(run):
    tmp = run["tmp"]
    assert min(run["margins"]) > MARGIN
    _, rows = read_csv(tmp / "jax" / "baseline_metrics.csv")
    for i, (row, want) in enumerate(zip(run["rows"], rows)):
        got = (tmp / "torch" / "bitstreams" / f"im{i}.rdeic").read_bytes()
        assert got == (tmp / "jax" / "bitstreams" / f"im{i}.rdeic").read_bytes()
        assert row["name"] == want["name"] and row["bpp"] == float(want["bpp"])


def test_reconstructions_agree_before_and_after_to_uint8(run):
    for i, (got, want) in enumerate(zip(run["out01"], run["want01"])):
        assert got.shape == (*SIZES[i], 3)
        np.testing.assert_allclose(got, want, atol=ATOL)
        saved = read_rgb(run["tmp"] / "jax" / f"im{i}.png")
        np.testing.assert_array_equal(to_uint8(want), saved)
        diff = np.abs(to_uint8(got).astype(int) - saved)
        assert diff.max() <= 1 and diff.mean() < 1e-3


def test_rows_match_the_root_csv(run):
    tmp = run["tmp"]
    header, rows = read_csv(tmp / "jax" / "baseline_metrics.csv")
    assert read_csv(tmp / "torch" / "baseline_metrics.csv")[0] == header == COLUMNS
    fns = {n: run["ts"].create_metric(n) for n in t_baseline.METRICS}
    for i, (row, want) in enumerate(zip(run["rows"], rows)):
        assert np.isnan(row["ms_ssim"]) and want["ms_ssim"] == "nan"
        check_metrics(row, want, t_baseline.METRICS)
        # the port's metric code on the root script's own image
        again = score_images(fns, run["refs"][i],
                             read_rgb(tmp / "jax" / f"im{i}.png"), "cpu")
        for n in t_baseline.METRICS:
            tol = dict(rtol=1e-5) if n == "psnr" else dict(atol=1e-5)
            np.testing.assert_allclose(again[n], float(want[n]), **tol,
                                       err_msg=n)


def test_cli_writes_the_root_scripts_streams_and_columns(run, tmp_path):
    """The port's CLI draws from a torch.Generator: the streams, bpp and
    columns are the root script's, the images its own."""
    tmp = run["tmp"]
    t_baseline.main(["--ckpt", str(tmp / "p.npz"), "--config",
                     str(tmp / "m.yaml"), "--input", str(tmp / "imgs"),
                     "--output", str(tmp_path), "--num_images", "2",
                     "--device", "cpu"])
    header, rows = read_csv(tmp_path / "baseline_metrics.csv")
    _, want = read_csv(tmp / "jax" / "baseline_metrics.csv")
    assert header == COLUMNS
    assert ([(r["name"], r["bpp"]) for r in rows]
            == [(r["name"], r["bpp"]) for r in want])
    for i in range(len(SIZES)):
        assert ((tmp_path / "bitstreams" / f"im{i}.rdeic").read_bytes()
                == (tmp / "jax" / "bitstreams" / f"im{i}.rdeic").read_bytes())
        assert read_rgb(tmp_path / f"im{i}.png").shape == (*SIZES[i], 3)


def test_image_checker_matches_the_root_script(run, tmp_path):
    """check.csv, the difference PNGs and the averages of the root
    image_checker.py on the root baseline's outputs, one of them resized
    (LANCZOS) to a reference of another size."""
    from PIL import Image

    tmp = run["tmp"]
    recon = tmp_path / "recon"
    recon.mkdir()
    for i in range(len(SIZES)):
        img = Image.open(tmp / "jax" / f"im{i}.png")
        (img.resize((150, 140)) if i else img).save(recon / f"im{i}.png")
    argv = ["--ref_dir", str(tmp / "imgs"), "--recon_dir", str(recon),
            "--save_diff"]
    printed = run_root("image_checker",
                       [*argv, "--output", str(tmp_path / "jax")], None, None,
                       run["js"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_checker, "MetricSuite", lambda: run["ts"])
        t_checker.main([*argv, "--output", str(tmp_path / "torch"),
                        "--device", "cpu"])
    header, rows = read_csv(tmp_path / "torch" / "check.csv")
    want_header, want = read_csv(tmp_path / "jax" / "check.csv")
    assert header == want_header == ["name", "psnr", "mse", "mae", "lpips"]
    for row, w in zip(rows, want):
        assert row["name"] == w["name"]
        np.testing.assert_allclose([float(row[k]) for k in header[1:]],
                                   [float(w[k]) for k in header[1:]],
                                   rtol=1e-5, atol=1e-5)
    for i in range(len(SIZES)):
        np.testing.assert_array_equal(
            read_rgb(tmp_path / "torch" / f"im{i}_diff.png"),
            read_rgb(tmp_path / "jax" / f"im{i}_diff.png"))
    floats = [{k: v if k == "name" else float(v) for k, v in w.items()}
              for w in want]
    assert f"averages: {t_checker.averages(floats)}" in printed
