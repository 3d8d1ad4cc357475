"""NIQE (Natural Image Quality Evaluator) — no-reference quality metric
(a copy of rdeic_tpu/utils/niqe.py: numpy and scipy on the host, in both
packages).

Role parity: the pyiqa `niqe` metric used by the reference's OOD harness
(experiments/run_ood.py no-reference metrics). Implemented from the
published formulation (Mittal et al., "Making a 'Completely Blind' Image
Quality Analyzer", 2013): MSCN coefficients -> per-patch GGD/AGGD features
-> multivariate-Gaussian distance to a pristine model.

Standalone-framework design: the pristine MVG parameters are not shipped
(no network access to the canonical .mat); instead `fit_pristine()` fits
them from any folder of high-quality images and `save/load` round-trips
them, so the metric is fully self-contained.
"""
from __future__ import annotations

import math
import numpy as np
from scipy.ndimage import gaussian_filter

_GAMMAS = np.arange(0.2, 10.001, 0.001)
_R_GAM = (
    (np.vectorize(math.gamma)(2.0 / _GAMMAS)) ** 2
    / (
        np.vectorize(math.gamma)(1.0 / _GAMMAS)
        * np.vectorize(math.gamma)(3.0 / _GAMMAS)
    )
)


def _estimate_ggd(vec: np.ndarray) -> tuple[float, float]:
    """Generalized-Gaussian shape + scale for zero-mean samples."""
    sigma_sq = np.mean(vec**2)
    sigma = math.sqrt(max(sigma_sq, 1e-12))
    e = np.mean(np.abs(vec))
    rho = sigma_sq / max(e**2, 1e-12)
    idx = int(np.argmin(np.abs(_R_GAM - 1.0 / rho)))
    return float(_GAMMAS[idx]), sigma


def _estimate_aggd(vec: np.ndarray):
    """Asymmetric GGD params (alpha, left sigma, right sigma, mean)."""
    left = vec[vec < 0]
    right = vec[vec >= 0]
    sigma_l = math.sqrt(np.mean(left**2)) if left.size else 1e-6
    sigma_r = math.sqrt(np.mean(right**2)) if right.size else 1e-6
    gamma_hat = sigma_l / max(sigma_r, 1e-12)
    e = np.mean(np.abs(vec))
    rho = np.mean(vec**2) / max(e**2, 1e-12)
    rhat = rho * (gamma_hat**3 + 1) * (gamma_hat + 1) / (gamma_hat**2 + 1) ** 2
    idx = int(np.argmin(np.abs(_R_GAM - 1.0 / max(rhat, 1e-12))))
    alpha = float(_GAMMAS[idx])
    const = math.gamma(2.0 / alpha) / math.gamma(1.0 / alpha)
    mean = (sigma_r - sigma_l) * const
    return alpha, sigma_l, sigma_r, mean


def _mscn(gray: np.ndarray, sigma: float = 7.0 / 6.0) -> np.ndarray:
    mu = gaussian_filter(gray, sigma, truncate=3.0)
    var = gaussian_filter(gray**2, sigma, truncate=3.0) - mu**2
    return (gray - mu) / (np.sqrt(np.maximum(var, 0)) + 1.0)


def _patch_features(mscn: np.ndarray) -> np.ndarray:
    feats = []
    alpha, sigma = _estimate_ggd(mscn.reshape(-1))
    feats += [alpha, sigma**2]
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for dy, dx in shifts:
        paired = (mscn * np.roll(mscn, (dy, dx), axis=(0, 1))).reshape(-1)
        a, sl, sr, m = _estimate_aggd(paired)
        feats += [a, m, sl**2, sr**2]
    return np.asarray(feats, np.float64)  # 18 features


def niqe_features(
    img01: np.ndarray, patch: int = 96
) -> np.ndarray:
    """[H, W, 3] or [H, W] in [0,1] -> [n_patches, 36] feature matrix."""
    if img01.ndim == 3:
        gray = (
            0.299 * img01[..., 0] + 0.587 * img01[..., 1] + 0.114 * img01[..., 2]
        )
    else:
        gray = img01
    gray = gray.astype(np.float64) * 255.0
    h, w = gray.shape
    h2, w2 = (h // patch) * patch, (w // patch) * patch
    if h2 < patch or w2 < patch:
        raise ValueError(f"image too small for NIQE patch size {patch}")
    gray = gray[:h2, :w2]
    m1 = _mscn(gray)
    # half-resolution second scale
    small = gray[::2, ::2]
    m2 = _mscn(small)
    rows = []
    for y in range(0, h2, patch):
        for x in range(0, w2, patch):
            f1 = _patch_features(m1[y : y + patch, x : x + patch])
            f2 = _patch_features(
                m2[y // 2 : (y + patch) // 2, x // 2 : (x + patch) // 2]
            )
            rows.append(np.concatenate([f1, f2]))
    return np.stack(rows)


class NIQEModel:
    """Pristine MVG model: fit on clean images, then score arbitrary ones."""

    def __init__(self, mu: np.ndarray, cov: np.ndarray):
        self.mu = mu
        self.cov = cov

    @classmethod
    def fit_pristine(cls, images01) -> "NIQEModel":
        feats = np.concatenate([niqe_features(np.asarray(im)) for im in images01])
        mu = feats.mean(axis=0)
        cov = np.cov(feats, rowvar=False)
        return cls(mu, cov)

    @classmethod
    def load(cls, path: str) -> "NIQEModel":
        data = np.load(path)
        return cls(data["mu"], data["cov"])

    def save(self, path: str) -> None:
        np.savez(path, mu=self.mu, cov=self.cov)

    def score(self, img01: np.ndarray) -> float:
        """Lower = more natural. Distance between the pristine MVG and the
        image's patch-feature MVG (NIQE eq. 9)."""
        feats = niqe_features(np.asarray(img01))
        mu_d = feats.mean(axis=0)
        cov_d = np.cov(feats, rowvar=False)
        cov_avg = (self.cov + cov_d) / 2.0
        pinv = np.linalg.pinv(cov_avg)
        d = self.mu - mu_d
        return float(math.sqrt(max(d @ pinv @ d, 0.0)))
