"""FID and Inception Score from streamed moments: host math in float64.

Counterpart of `maskbit_tpu/eval/fid.py`, as the port's own copy (numpy and
`scipy.linalg.sqrtm`): the covariance from the sum of outer products and
the sum of features, the Frechet distance with the original repo's order of
fallbacks (the eps offset for a non-finite `sqrtm` first, then the check of
the imaginary part), the Inception Score from the streamed sum of p and of
p log p, and the ADM-format `.npz` statistics (keys `mu`, `sigma`).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
from scipy import linalg


def _sqrtm_quiet(a: np.ndarray) -> np.ndarray:
    """Matrix square root without the inaccuracy print: scipy < 1.18 needs
    disp=False and returns (sqrtm, errest); 1.18 removes `disp`."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return linalg.sqrtm(a, disp=False)[0]
    except TypeError:
        return linalg.sqrtm(a)


def get_covariance(sigma_sum: np.ndarray, total_sum: np.ndarray, num_examples: int) -> np.ndarray:
    """Unbiased covariance from the sum of outer products and of features."""
    num = float(num_examples)
    sub = np.outer(total_sum, total_sum) / num
    return (sigma_sum - sub) / (num - 1)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """FID between two Gaussians, `sqrtm` on the host."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # a non-finite sqrtm (complex NaN included) reaches the eps fallback
    # before the imaginary part is checked
    covmean = _sqrtm_quiet(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        warnings.warn("FID covariance product nearly singular; using eps fallback")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm_quiet((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)

    fid = float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)
    if not np.isfinite(fid):
        warnings.warn("The product of covariances of the features is out of bounds.")
    return fid


def fid_from_moments(real_total: np.ndarray, real_sigma_sum: np.ndarray,
                     fake_total: np.ndarray, fake_sigma_sum: np.ndarray,
                     num_examples: int) -> float:
    mu_real = real_total / num_examples
    mu_fake = fake_total / num_examples
    sigma_real = get_covariance(real_sigma_sum, real_total, num_examples)
    sigma_fake = get_covariance(fake_sigma_sum, fake_total, num_examples)
    return frechet_distance(mu_real, sigma_real, mu_fake, sigma_fake)


def inception_score_from_moments(prob_total: np.ndarray, kl_total: np.ndarray,
                                 num_examples: int, eps: float = 1e-16) -> float:
    """IS from the streamed sum of p and of p log p."""
    mean_probs = prob_total / num_examples
    log_mean_probs = np.log(mean_probs + eps)
    excess_entropy = prob_total * log_mean_probs
    avg_kl_d = np.sum(kl_total - excess_entropy) / num_examples
    return float(np.exp(avg_kl_d))


def load_stats_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """ADM-format precomputed statistics (keys 'mu', 'sigma')."""
    with np.load(path) as f:
        return f["mu"], f["sigma"]


def save_stats_npz(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez(path, mu=mu, sigma=sigma)
