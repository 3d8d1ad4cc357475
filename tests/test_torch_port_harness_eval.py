"""`python -m rdeic_torch.experiments.run_ood` against the root
experiments/run_ood.py on the CPU, at the micro config with the same random
weights and LPIPS weights.

The root script runs on the test's JAX model; its noise is one
`jax.random.split` of PRNGKey(--seed) a test-time draw, carried across the
domains, and the port's `eval_domain` is handed the same draws as
`noise()`. Limits: streams, bpp, the NIQE and BRISQUE fits and the kept draw
equal; each metric within tests/torch_port_harness.py's METRIC_TOL of the
root CSV's. The images are NIQE's least size (one 96-px patch a scale),
which the self-fit reads."""
import argparse

import jax
import numpy as np
import pytest

from rdeic_torch.experiments import run_ood as t_ood
from rdeic_torch.utils.image import read_rgb, to_uint8
from rdeic_tpu.utils.brisque import BRISQUEModel
from rdeic_tpu.utils.niqe import NIQEModel
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_harness import (
    STEPS, check_metrics, jax_noise, read_csv, run_root, save_images, suites)
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    micro_pair, one_torch_thread_per_module)

SEED, TTA = 231, 2
OOD_HW = (96, 100)  # pads to 128x128
LATENT = (1, 64, 64, 4)
COLUMNS = ["name", "domain", "bpp", "psnr", "ms_ssim", "lpips", "niqe",
           "brisque"]


@pytest.fixture(scope="module")
def ood(tmp_path_factory):
    """Both packages over two domains (a folder of two images, a .list of
    one of them), --tta_samples 2 and --nr_metrics (self-fit models)."""
    tmp = tmp_path_factory.mktemp("ood")
    jm, params, tm = micro_pair(seed=4)
    save_images(tmp / "a", [OOD_HW, OOD_HW], seed=5)
    (tmp / "one.list").write_text(str(tmp / "a" / "im1.png") + "\n")
    js, ts = suites(seed=6)
    printed = run_root("experiments.run_ood", [
        "--ckpt", "unused.npz", "--input", f"{tmp / 'a'},{tmp / 'one.list'}",
        "--domain", "a,b", "--output", str(tmp / "jax"), "--tta_samples",
        str(TTA), "--nr_metrics", "--seed", str(SEED)], jm, params, js)
    args = argparse.Namespace(
        num_images=0, nr_metrics=True, niqe_model=None, brisque_model=None,
        output=str(tmp / "torch"), steps=STEPS, tta_samples=TTA)
    fns = {n: ts.create_metric(n) for n in t_ood.METRICS}
    noise = jax_noise(SEED, LATENT)
    rows = (t_ood.eval_domain(args, tm, fns, str(tmp / "a"), "a", noise)
            + t_ood.eval_domain(args, tm, fns, str(tmp / "one.list"), "b",
                                noise))
    return dict(tmp=tmp, jm=jm, params=params, tm=tm, js=js, fns=fns,
                printed=printed, rows=rows)


def test_ood_rows_match_the_root_script(ood):
    tmp = ood["tmp"]
    header, want = read_csv(tmp / "jax" / "ood_results_all.csv")
    assert header == COLUMNS
    assert [list(r) for r in ood["rows"]] == [COLUMNS] * 3
    for got, w in zip(ood["rows"], want):
        assert (got["name"], got["domain"]) == (w["name"], w["domain"])
        assert got["bpp"] == float(w["bpp"])
        assert np.isfinite(got["brisque"])
        check_metrics(got, w, COLUMNS[3:])
    for domain in ("a", "b"):
        h, w = read_csv(tmp / "jax" / domain / "ood_metrics.csv")
        assert read_csv(tmp / "torch" / domain / "ood_metrics.csv")[0] == h
        assert [r["name"] for r in w] == [
            r["name"] for r in ood["rows"] if r["domain"] == domain]
        for name in (r["name"] for r in w):
            got = tmp / "torch" / domain / "bitstreams" / f"{name}.rdeic"
            assert got.read_bytes() == (tmp / "jax" / domain / "bitstreams"
                                        / f"{name}.rdeic").read_bytes()
            assert read_rgb(tmp / "torch" / domain / f"{name}.png").shape == \
                (*OOD_HW, 3)


def test_ood_summary_lines_are_the_root_scripts(ood):
    """The port's summary of the root script's own rows prints its lines."""
    _, want = read_csv(ood["tmp"] / "jax" / "ood_results_all.csv")
    rows = [{k: v if k in ("name", "domain") else float(v)
             for k, v in r.items()} for r in want]
    lines = t_ood.domain_summary(["a", "b"], rows)
    assert len(lines) == 2 and all(line in ood["printed"] for line in lines)
    assert ("fitted pristine ['niqe', 'brisque'] models from 2 domain "
            "originals") in ood["printed"]


def test_ood_self_fit_models_equal_the_root_scripts(ood, tmp_path):
    """The models a domain fits from its originals of 96 px a side or
    more: the JAX package's NIQE and BRISQUE fits, bit for bit; a given
    .npz is loaded and only the other one fit; none is fit from smaller
    images."""
    arrays = [read_rgb(ood["tmp"] / "a" / f"im{i}.png") for i in range(2)]
    small = arrays[0][:95]
    got = t_ood.nr_models(None, None, iter([*arrays, small]))
    pristine = [a.astype(np.float64) / 255.0 for a in arrays]
    for name, cls in (("niqe", NIQEModel), ("brisque", BRISQUEModel)):
        want = cls.fit_pristine(pristine)
        np.testing.assert_array_equal(got[name].mu, want.mu)
        np.testing.assert_array_equal(got[name].cov, want.cov)
    got["niqe"].save(tmp_path / "n.npz")
    loaded = t_ood.nr_models(str(tmp_path / "n.npz"), None, iter(arrays))
    assert list(loaded) == ["niqe", "brisque"]
    np.testing.assert_array_equal(loaded["niqe"].cov, got["niqe"].cov)
    assert t_ood.nr_models(None, None, iter([small])) == {}


def test_tta_keeps_the_root_scripts_draw(ood):
    """The first image of the run: each of its draws decoded by both
    packages; the port keeps the draw the root script's LPIPS picks."""
    jm, params, tmp = ood["jm"], ood["params"], ood["tmp"]
    arr = read_rgb(tmp / "a" / "im0.png")
    key, subs = jax.random.PRNGKey(SEED), []
    for _ in range(TTA):
        key, sub = jax.random.split(key)
        subs.append(sub)
    c_latent, hint = jm.apply_condition_decompress(
        params, str(tmp / "jax" / "a" / "bitstreams" / "im0.rdeic"))
    lp_fn = ood["js"].create_metric("lpips")
    ref = jax.numpy.asarray(arr, jax.numpy.float32)[None] / 255.0
    want = []
    for sub in subs:
        out = np.asarray(jm.jitted_decode(steps=STEPS)(params, c_latent, hint,
                                                       sub))
        b = to_uint8(out[0])[:OOD_HW[0], :OOD_HW[1]].astype(np.float32) / 255.0
        want.append(float(lp_fn(ref, jax.numpy.asarray(b)[None])[0]))
    draws = []
    for sub in subs:
        relay, steps = _jax_noise(sub, LATENT, STEPS)
        draws.append({"relay_noise": relay, "step_noise": steps})
    row, recon, pick = t_ood.eval_image(ood["tm"], arr, tmp / "tta.rdeic",
                                        STEPS, ood["fns"], {}, draws)
    assert pick == int(np.argmin(want))
    np.testing.assert_allclose(row["lpips"], min(want), atol=1e-4)
    assert recon.shape == (*OOD_HW, 3) and recon.dtype == np.uint8
