"""rdeic_torch.utils.niqe and utils.brisque against rdeic_tpu's on the CPU:
the same float64 numpy and scipy code, so every feature, fitted model and
score is compared exactly (atol 0); the saved models load in the other
package."""
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from rdeic_torch.utils import brisque as tb
from rdeic_torch.utils import niqe as tn
from rdeic_tpu.utils import brisque as jb
from rdeic_tpu.utils import niqe as jn


def _image(seed: int, hw=(192, 200), noise: float = 0.0) -> np.ndarray:
    """A smooth random RGB field in [0, 1] (a stand-in for a natural image),
    plus white noise of std `noise`."""
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(size=(*hw, 3)), sigma=(3, 3, 0))
    img = (img - img.min()) / (img.max() - img.min())
    return np.clip(img + noise * rng.normal(size=img.shape), 0, 1)


PRISTINE = [_image(s) for s in range(4)]


@pytest.mark.parametrize("shape", [(40, 50), (97, 33)])
def test_estimators_and_mscn_equal_jax(shape):
    rng = np.random.default_rng(1)
    vec = rng.laplace(size=shape).reshape(-1)
    assert tn._estimate_ggd(vec) == jn._estimate_ggd(vec)
    assert tn._estimate_aggd(vec) == jn._estimate_aggd(vec)
    gray = rng.uniform(0, 255, shape)
    np.testing.assert_array_equal(tn._mscn(gray), jn._mscn(gray))


@pytest.mark.parametrize("img", [_image(7), _image(8, (100, 300))[..., 0],
                                 _image(9, noise=0.1).astype(np.float32)],
                         ids=["rgb", "gray", "rgb-float32"])
def test_niqe_features_equal_jax(img):
    got = tn.niqe_features(img)
    np.testing.assert_array_equal(got, jn.niqe_features(img))
    assert got.shape[1] == 36 and np.isfinite(got).all()


def test_niqe_refuses_an_image_under_its_patch_like_jax():
    for mod in (tn, jn):
        with pytest.raises(ValueError, match="too small"):
            mod.niqe_features(_image(3, (95, 300)))


def test_niqe_fit_score_save_load_equal_jax(tmp_path):
    got, want = tn.NIQEModel.fit_pristine(PRISTINE), jn.NIQEModel.fit_pristine(PRISTINE)
    np.testing.assert_array_equal(got.mu, want.mu)
    np.testing.assert_array_equal(got.cov, want.cov)
    clean, noisy = _image(11), _image(11, noise=0.08)
    scores = [got.score(clean), got.score(noisy)]
    assert scores == [want.score(clean), want.score(noisy)]
    assert scores[0] < scores[1]  # noise reads as less natural
    got.save(tmp_path / "t.npz")
    want.save(tmp_path / "j.npz")
    assert jn.NIQEModel.load(tmp_path / "t.npz").score(noisy) == scores[1]
    assert tn.NIQEModel.load(tmp_path / "j.npz").score(noisy) == scores[1]


@pytest.mark.parametrize("img", [_image(12), _image(13, (64, 80))[..., 1],
                                 _image(14, noise=0.2)],
                         ids=["rgb", "gray-small", "noisy"])
def test_brisque_features_equal_jax(img):
    got = tb.brisque_features(img)
    np.testing.assert_array_equal(got, jb.brisque_features(img))
    assert got.shape == (36,) and np.isfinite(got).all()


@pytest.mark.parametrize("n", [1, 4])
def test_brisque_fit_score_save_load_equal_jax(tmp_path, n):
    """One image fits an identity covariance in both; four fit theirs."""
    got = tb.BRISQUEModel.fit_pristine(PRISTINE[:n])
    want = jb.BRISQUEModel.fit_pristine(PRISTINE[:n])
    np.testing.assert_array_equal(got.mu, want.mu)
    np.testing.assert_array_equal(got.cov, want.cov)
    if n == 1:
        np.testing.assert_array_equal(got.cov, np.eye(36))
    noisy = _image(15, noise=0.1)
    score = got.score(noisy)
    assert score == want.score(noisy) and np.isfinite(score)
    got.save(tmp_path / "t.npz")
    assert jb.BRISQUEModel.load(tmp_path / "t.npz").score(noisy) == score
    want.save(tmp_path / "j.npz")
    assert tb.BRISQUEModel.load(tmp_path / "j.npz").score(noisy) == score
