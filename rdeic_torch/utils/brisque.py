"""BRISQUE no-reference quality features (+ self-fit scoring); a copy of
rdeic_tpu/utils/brisque.py, on the helpers of the port's utils/niqe.py.

Role parity: the pyiqa `brisque` metric used by the reference's OOD harness
(experiments/run_ood.py no-reference metrics). The 36-dim feature vector is
implemented from the published formulation (Mittal et al., "No-Reference
Image Quality Assessment in the Spatial Domain", TIP 2012): whole-image MSCN
GGD + 4 pairwise-product AGGD fits, at full and half resolution.

Standalone-framework deviation (documented in PARITY.md): canonical BRISQUE
maps features -> score with an SVR trained on the LIVE database; those
trained SVR weights are not redistributable data we have offline. Instead
`BRISQUEModel` scores by multivariate-Gaussian distance to a self-fit
pristine model (same scheme as our NIQE) — monotone in distortion severity,
NOT numerically comparable to LIVE-SVR BRISQUE scores.
"""
from __future__ import annotations

import math

import numpy as np

from rdeic_torch.utils.niqe import _estimate_aggd, _estimate_ggd, _mscn


def brisque_features(img01: np.ndarray) -> np.ndarray:
    """[H, W, 3] or [H, W] in [0,1] -> 36-dim BRISQUE feature vector.

    18 features per scale (2 GGD + 4x4 AGGD), 2 scales (full, half).
    """
    if img01.ndim == 3:
        gray = (
            0.299 * img01[..., 0] + 0.587 * img01[..., 1] + 0.114 * img01[..., 2]
        )
    else:
        gray = img01
    gray = gray.astype(np.float64) * 255.0
    feats = []
    for _scale in range(2):
        m = _mscn(gray)
        alpha, sigma = _estimate_ggd(m.reshape(-1))
        feats += [alpha, sigma**2]
        for dy, dx in [(0, 1), (1, 0), (1, 1), (1, -1)]:
            paired = (m * np.roll(m, (dy, dx), axis=(0, 1))).reshape(-1)
            a, sl, sr, mean = _estimate_aggd(paired)
            feats += [a, mean, sl**2, sr**2]
        gray = gray[::2, ::2]
    return np.asarray(feats, np.float64)


class BRISQUEModel:
    """Pristine MVG over BRISQUE features: fit on clean images, score others.

    Lower = closer to the pristine statistics (more natural).
    """

    def __init__(self, mu: np.ndarray, cov: np.ndarray):
        self.mu = mu
        self.cov = cov

    @classmethod
    def fit_pristine(cls, images01) -> "BRISQUEModel":
        feats = np.stack([brisque_features(np.asarray(im)) for im in images01])
        mu = feats.mean(axis=0)
        cov = np.cov(feats, rowvar=False) if len(feats) > 1 else np.eye(36)
        return cls(mu, cov)

    @classmethod
    def load(cls, path: str) -> "BRISQUEModel":
        data = np.load(path)
        return cls(data["mu"], data["cov"])

    def save(self, path: str) -> None:
        np.savez(path, mu=self.mu, cov=self.cov)

    def score(self, img01: np.ndarray) -> float:
        f = brisque_features(np.asarray(img01))
        cov = self.cov + 1e-6 * np.eye(len(self.mu))
        pinv = np.linalg.pinv(cov)
        d = self.mu - f
        return float(math.sqrt(max(d @ pinv @ d, 0.0)))
