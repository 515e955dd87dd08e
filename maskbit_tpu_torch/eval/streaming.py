"""Streaming quality evaluators for the tokenizer and the generator.

Counterpart of `maskbit_tpu/eval/streaming.py`:
  * `TokenizerEvaluator`: MAE, MSE, PSNR, SSIM (depthwise 11x11 Gaussian,
    sigma 1.5, reflect padding, data range 1), LPIPS, Inception Score,
    rFID, codebook usage and codebook entropy, as streaming sums;
  * `GeneratorEvaluator`: Inception Score and FID of generated images
    against precomputed statistics.
Each batch's contributions are computed in float32 on the images' device
(TF32 off for the SSIM convolution); the running sums live on the host in
float64, as in the JAX package. Images are NHWC in [0, 1], as tensors on
any device or numpy arrays; fake images become uint8 (`clip(x * 255)`
truncated, in the images' dtype) before the Inception network.

Across data-parallel processes each evaluator accumulates its share and
`merge_across_hosts` (a collective every process runs) sums the
accumulators over the processes through the bit-exact float64 allgather,
after checking that every process enables the same metrics.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from maskbit_tpu_torch.eval import fid as fid_lib
from maskbit_tpu_torch.eval.adm import sum_across_processes as total
from maskbit_tpu_torch.eval.adm import to_float64
from maskbit_tpu_torch.parallel.mesh import assert_host_agreement, process_count
from maskbit_tpu_torch.utils.precision import full_f32


def gaussian_kernel_2d(kernel_size=(11, 11), sigma=(1.5, 1.5)) -> np.ndarray:
    """Normalised 2D Gaussian, float32."""

    def gaussian_1d(size, s):
        ksize_half = (size - 1) * 0.5
        k = np.linspace(-ksize_half, ksize_half, size)
        gauss = np.exp(-0.5 * (k / s) ** 2)
        return gauss / gauss.sum()

    kh = gaussian_1d(kernel_size[0], sigma[0])
    kw = gaussian_1d(kernel_size[1], sigma[1])
    return np.outer(kh, kw).astype(np.float32)


def _ssim_sum(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Sum over the batch of each image's mean SSIM (NHWC, data range 1)."""
    c1, c2 = 0.01**2, 0.03**2
    real = real.float().permute(0, 3, 1, 2)
    fake = fake.float().permute(0, 3, 1, 2)
    channels = real.shape[1]
    kern = torch.from_numpy(gaussian_kernel_2d()).to(real.device)
    kern = kern[None, None].expand(channels, 1, -1, -1)

    def depthwise(x):
        return F.conv2d(F.pad(x, (5, 5, 5, 5), mode="reflect"), kern, groups=channels)

    with full_f32():
        mu_f, mu_r = depthwise(fake), depthwise(real)
        sigma_f = depthwise(fake**2) - mu_f**2
        sigma_r = depthwise(real**2) - mu_r**2
        sigma_fr = depthwise(fake * real) - mu_f * mu_r
    a1 = 2 * mu_f * mu_r + c1
    a2 = 2 * sigma_fr + c2
    b1 = mu_f**2 + mu_r**2 + c1
    b2 = sigma_f + sigma_r + c2
    return ((a1 * a2) / (b1 * b2)).mean(dim=(1, 2, 3)).sum()


def _pixel_sums(real: torch.Tensor, fake: torch.Tensor):
    real, fake = real.float(), fake.float()
    dims = tuple(range(1, real.ndim))
    mae = (fake - real).abs().mean(dim=dims).sum()
    mse_per = ((fake - real) ** 2).mean(dim=dims)
    psnr = (10.0 * torch.log10(1.0 / (mse_per + 1e-10))).sum()
    return mae, mse_per.sum(), psnr


def _inception_moments(probs: torch.Tensor, eps: float = 1e-16):
    return probs.sum(dim=0), (probs * torch.log(probs + eps)).sum(dim=0)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> uint8, `clip(x * 255, 0, 255)` truncated, computed in
    the images' dtype as the JAX package does."""
    return (images * 255.0).clamp(0, 255).to(torch.uint8)


def _probs(feats) -> torch.Tensor:
    return torch.softmax(feats["logits_unbiased"].float(), dim=-1)


class TokenizerEvaluator:
    """Streaming reconstruction-quality evaluator."""

    def __init__(
        self,
        inception_fn: Optional[Callable] = None,
        lpips_fn: Optional[Callable] = None,
        enable_rfid: bool = False,
        enable_inception_score: bool = False,
        enable_psnr_score: bool = False,
        enable_ssim_score: bool = False,
        enable_lpips_score: bool = False,
        enable_mse_error: bool = False,
        enable_mae_error: bool = False,
        enable_codebook_usage_measure: bool = False,
        enable_codebook_entropy_measure: bool = False,
        num_codebook_entries: int = 1024,
    ):
        """`inception_fn(uint8_images_nhwc) -> {'2048', 'logits_unbiased'}`;
        `lpips_fn(real, fake) -> per-image distances`."""
        if (enable_rfid or enable_inception_score) and inception_fn is None:
            raise ValueError("rFID / InceptionScore require an inception_fn")
        if enable_lpips_score and lpips_fn is None:
            raise ValueError("LPIPS requires an lpips_fn")
        self._inception_fn = inception_fn
        self._lpips_fn = lpips_fn
        self._enable_rfid = enable_rfid
        self._enable_inception_score = enable_inception_score
        self._enable_psnr_score = enable_psnr_score
        self._enable_ssim_score = enable_ssim_score
        self._enable_lpips_score = enable_lpips_score
        self._enable_mse_error = enable_mse_error
        self._enable_mae_error = enable_mae_error
        self._enable_codebook_usage_measure = enable_codebook_usage_measure
        self._enable_codebook_entropy_measure = enable_codebook_entropy_measure
        self._num_codebook_entries = num_codebook_entries
        self._is_eps = 1e-16
        self.reset_metrics()

    def reset_metrics(self):
        self._num_examples = 0
        self._num_updates = 0
        self._mae_sum = 0.0
        self._mse_sum = 0.0
        self._psnr_sum = 0.0
        self._ssim_sum = 0.0
        self._lpips_sum = 0.0
        self._is_prob_total = np.zeros(1008, np.float64)
        self._is_total_kl_d = np.zeros(1008, np.float64)
        self._rfid_real_total = np.zeros(2048, np.float64)
        self._rfid_fake_total = np.zeros(2048, np.float64)
        self._rfid_real_sigma = np.zeros((2048, 2048), np.float64)
        self._rfid_fake_sigma = np.zeros((2048, 2048), np.float64)
        self._codebook_set = set()
        self._codebook_frequencies = np.zeros(self._num_codebook_entries, np.float64)

    @torch.inference_mode()
    def update(self, real_images, fake_images, codebook_indices=None):
        """real/fake: NHWC in [0, 1]."""
        real_images, fake_images = _as_tensor(real_images), _as_tensor(fake_images)
        self._num_examples += real_images.shape[0]
        self._num_updates += 1

        if self._enable_mae_error or self._enable_mse_error or self._enable_psnr_score:
            mae, mse, psnr = _pixel_sums(real_images, fake_images)
            self._mae_sum += float(mae)
            self._mse_sum += float(mse)
            self._psnr_sum += float(psnr)

        if self._enable_ssim_score:
            self._ssim_sum += float(_ssim_sum(real_images, fake_images))

        if self._enable_inception_score or self._enable_rfid:
            feat_fake = self._inception_fn(to_uint8(fake_images))

        if self._enable_inception_score:
            prob_sum, kl_sum = _inception_moments(_probs(feat_fake), self._is_eps)
            self._is_prob_total += to_float64(prob_sum)
            self._is_total_kl_d += to_float64(kl_sum)

        if self._enable_rfid:
            feat_real = self._inception_fn(to_uint8(real_images))
            f_real, f_fake = to_float64(feat_real["2048"]), to_float64(feat_fake["2048"])
            self._rfid_real_total += f_real.sum(0)
            self._rfid_fake_total += f_fake.sum(0)
            self._rfid_real_sigma += f_real.T @ f_real
            self._rfid_fake_sigma += f_fake.T @ f_fake

        if self._enable_lpips_score:
            self._lpips_sum += float(_as_tensor(self._lpips_fn(real_images, fake_images)).sum())

        if self._enable_codebook_usage_measure or self._enable_codebook_entropy_measure:
            indices = _as_tensor(codebook_indices).cpu().numpy()
        if self._enable_codebook_usage_measure:
            self._codebook_set |= set(np.unique(indices).tolist())
        if self._enable_codebook_entropy_measure:
            entries, counts = np.unique(indices, return_counts=True)
            self._codebook_frequencies[entries.astype(np.int64)] += counts.astype(np.float64)

    def merge_across_hosts(self) -> None:
        """Sum the accumulators over the processes (collective; nothing to do
        in one process). The codebook-usage set travels as a presence vector
        (union = elementwise max). The enable flags decide which collectives
        run, so they are checked to agree first."""
        if process_count() == 1:
            return
        flags = {"mae": self._enable_mae_error, "mse": self._enable_mse_error,
                 "psnr": self._enable_psnr_score, "ssim": self._enable_ssim_score,
                 "lpips": self._enable_lpips_score,
                 "inception_score": self._enable_inception_score, "rfid": self._enable_rfid,
                 "codebook_usage": self._enable_codebook_usage_measure,
                 "codebook_entropy": self._enable_codebook_entropy_measure}
        assert_host_agreement(flags, context="TokenizerEvaluator.merge_across_hosts")
        self._num_examples = int(total(self._num_examples))
        self._num_updates = int(total(self._num_updates))
        for flag, name in (("mae", "_mae_sum"), ("mse", "_mse_sum"), ("psnr", "_psnr_sum"),
                           ("ssim", "_ssim_sum"), ("lpips", "_lpips_sum")):
            if flags[flag]:
                setattr(self, name, float(total(getattr(self, name))))
        if self._enable_inception_score:
            self._is_prob_total = total(self._is_prob_total)
            self._is_total_kl_d = total(self._is_total_kl_d)
        if self._enable_rfid:
            self._rfid_real_total = total(self._rfid_real_total)
            self._rfid_fake_total = total(self._rfid_fake_total)
            self._rfid_real_sigma = total(self._rfid_real_sigma)
            self._rfid_fake_sigma = total(self._rfid_fake_sigma)
        if self._enable_codebook_usage_measure:
            presence = np.zeros(self._num_codebook_entries, np.float64)
            if self._codebook_set:
                presence[np.asarray(sorted(self._codebook_set), np.int64)] = 1.0
            self._codebook_set = set(np.nonzero(total(presence))[0].tolist())
        if self._enable_codebook_entropy_measure:
            self._codebook_frequencies = total(self._codebook_frequencies)

    def result(self) -> Mapping[str, float]:
        if self._num_examples < 1:
            raise ValueError("No examples to evaluate.")
        out = {}
        n = self._num_examples
        if self._enable_mae_error:
            out["MAE"] = self._mae_sum / n
        if self._enable_mse_error:
            out["MSE"] = self._mse_sum / n
        if self._enable_psnr_score:
            out["PSNR"] = self._psnr_sum / n
        if self._enable_ssim_score:
            out["SSIM"] = self._ssim_sum / n
        if self._enable_inception_score:
            out["InceptionScore"] = fid_lib.inception_score_from_moments(
                self._is_prob_total, self._is_total_kl_d, n, self._is_eps)
        if self._enable_rfid:
            out["rFID"] = fid_lib.fid_from_moments(
                self._rfid_real_total, self._rfid_real_sigma,
                self._rfid_fake_total, self._rfid_fake_sigma, n)
        if self._enable_lpips_score:
            out["LPIPS"] = self._lpips_sum / n
        if self._enable_codebook_usage_measure:
            out["CodebookUsage"] = len(self._codebook_set) / self._num_codebook_entries
        if self._enable_codebook_entropy_measure:
            probs = self._codebook_frequencies / self._codebook_frequencies.sum()
            out["CodebookEntropy"] = float(np.sum(-np.log2(probs + 1e-8) * probs))
        return out


class GeneratorEvaluator:
    """IS and FID of generated images against precomputed statistics."""

    def __init__(
        self,
        inception_fn: Callable,
        real_mu: Optional[np.ndarray] = None,
        real_sigma: Optional[np.ndarray] = None,
        enable_fid: bool = True,
        enable_inception_score: bool = True,
    ):
        self._inception_fn = inception_fn
        self._real_mu = real_mu
        self._real_sigma = real_sigma
        self._enable_fid = enable_fid and real_mu is not None
        self._enable_inception_score = enable_inception_score
        self._is_eps = 1e-16
        self.reset_metrics()

    def reset_metrics(self):
        self._num_examples = 0
        self._is_prob_total = np.zeros(1008, np.float64)
        self._is_total_kl_d = np.zeros(1008, np.float64)
        self._fake_total = np.zeros(2048, np.float64)
        self._fake_sigma = np.zeros((2048, 2048), np.float64)

    @torch.inference_mode()
    def update(self, fake_images):
        fake_images = _as_tensor(fake_images)
        self._num_examples += fake_images.shape[0]
        feats = self._inception_fn(to_uint8(fake_images))
        if self._enable_inception_score:
            prob_sum, kl_sum = _inception_moments(_probs(feats), self._is_eps)
            self._is_prob_total += to_float64(prob_sum)
            self._is_total_kl_d += to_float64(kl_sum)
        if self._enable_fid:
            f = to_float64(feats["2048"])
            self._fake_total += f.sum(0)
            self._fake_sigma += f.T @ f

    def merge_across_hosts(self) -> None:
        """Sum the accumulators over the processes (collective; nothing to do
        in one process). FID is on only where the stats file was found, a
        fact of each process's disk, so the flags are checked to agree
        first."""
        if process_count() == 1:
            return
        assert_host_agreement({"inception_score": self._enable_inception_score,
                               "fid(real stats npz found)": self._enable_fid},
                              context="GeneratorEvaluator.merge_across_hosts")
        self._num_examples = int(total(self._num_examples))
        if self._enable_inception_score:
            self._is_prob_total = total(self._is_prob_total)
            self._is_total_kl_d = total(self._is_total_kl_d)
        if self._enable_fid:
            self._fake_total = total(self._fake_total)
            self._fake_sigma = total(self._fake_sigma)

    def result(self) -> Mapping[str, float]:
        if self._num_examples < 1:
            raise ValueError("No examples to evaluate.")
        out = {}
        n = self._num_examples
        if self._enable_inception_score:
            out["InceptionScore"] = fid_lib.inception_score_from_moments(
                self._is_prob_total, self._is_total_kl_d, n, self._is_eps)
        if self._enable_fid:
            mu_fake = self._fake_total / n
            sigma_fake = fid_lib.get_covariance(self._fake_sigma, self._fake_total, n)
            out["FID"] = fid_lib.frechet_distance(self._real_mu, self._real_sigma, mu_fake,
                                                  sigma_fake)
        return out
