"""The ADM evaluation protocol (the headline gFID) over the port's Inception.

Counterpart of `maskbit_tpu/eval/adm.py`: `FIDStatistics` (the TTUR Frechet
distance), `Evaluator` (activations and logits of [0, 255] NHWC batches,
the ADM `.npz` statistics, the improved-GAN Inception Score over splits of
5000) and `AdmMomentAccumulator`, which streams the FID moments in float64
(the sum of activations, the sum of their outer products, the count) and
the Inception Score's moments per split, keyed by each sample's global
index, so that partial accumulators merge (`merge_state`) to exactly what
one accumulator over all samples holds.

One process only: `merge_across_hosts` does nothing in one process and
raises when `torch.distributed` is initialised (cross-process runs come
with the runtime slice, ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from maskbit_tpu_torch.eval.fid import frechet_distance, get_covariance


def to_float64(x) -> np.ndarray:
    """A tensor (any device) or array as a float64 numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def refuse_distributed(what: str) -> None:
    """Raise if this process is one of several: merges across processes
    are not ported yet."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        raise NotImplementedError(
            f"{what}: merging across processes is not ported to maskbit_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 4); run the evaluation in one process")


class FIDStatistics:
    def __init__(self, mu: np.ndarray, sigma: np.ndarray):
        self.mu = mu
        self.sigma = sigma

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6) -> float:
        assert self.mu.shape == other.mu.shape
        assert self.sigma.shape == other.sigma.shape
        return frechet_distance(self.mu, self.sigma, other.mu, other.sigma, eps=eps)


class Evaluator:
    """ADM-protocol evaluator over `inception_fn(images_0_255_nhwc) ->
    {'2048', 'logits_unbiased'}` (`cli.eval_tokenizer.make_inception_fn`)."""

    def __init__(self, inception_fn: Callable, softmax_batch_size: int = 512):
        self._inception_fn = inception_fn
        self.softmax_batch_size = softmax_batch_size

    def warmup(self):
        self.compute_activations([np.zeros((1, 64, 64, 3), np.float32)])

    def compute_activations(self, batches: Iterable[np.ndarray]) -> np.ndarray:
        """NHWC [0, 255] batches -> (N, 2048) pool features, float64."""
        return np.concatenate([to_float64(self._inception_fn(b)["2048"]) for b in batches])

    def compute_logits(self, batches: Iterable[np.ndarray]) -> np.ndarray:
        return np.concatenate([to_float64(self._inception_fn(b)["logits_unbiased"])
                               for b in batches])

    def read_statistics(self, npz_path: str, activations: Optional[np.ndarray]) -> FIDStatistics:
        obj = np.load(npz_path)
        if "mu" in list(obj.keys()):
            return FIDStatistics(obj["mu"], obj["sigma"])
        return self.compute_statistics(activations)

    def compute_statistics(self, activations: np.ndarray) -> FIDStatistics:
        mu = np.mean(activations, axis=0)
        sigma = np.cov(activations, rowvar=False)
        return FIDStatistics(mu, sigma)

    def compute_inception_score_from_logits(self, logits: np.ndarray,
                                            split_size: int = 5000) -> float:
        """The improved-GAN IS over splits of `split_size`."""
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        preds = e / e.sum(axis=-1, keepdims=True)
        scores = []
        for i in range(0, len(preds), split_size):
            part = preds[i:i + split_size]
            kl = part * (np.log(part) - np.log(np.expand_dims(np.mean(part, 0), 0)))
            scores.append(np.exp(np.mean(np.sum(kl, 1))))
        return float(np.mean(scores))


class AdmMomentAccumulator:
    """FID moments and per-split IS moments in float64, plain sums.

    IS identity: KL(split) = (sum p log p) / n - sum_c pbar_c log pbar_c with
    pbar = (sum p) / n, equal to the original's mean_i sum_c p (log p -
    log pbar)."""

    _ARRAYS = ("act_sum", "act_outer", "split_count", "split_plogp", "split_prob_sum")

    def __init__(self, dim: int = 2048, nclass: int = 1008,
                 total_samples: int = 50_000, split_size: int = 5000):
        self.split_size = split_size
        num_splits = max(1, (total_samples + split_size - 1) // split_size)
        self.count = 0
        self.act_sum = np.zeros(dim, np.float64)
        self.act_outer = np.zeros((dim, dim), np.float64)
        self.split_count = np.zeros(num_splits, np.int64)
        self.split_plogp = np.zeros(num_splits, np.float64)
        self.split_prob_sum = np.zeros((num_splits, nclass), np.float64)

    def update(self, acts, logits, global_indices: np.ndarray) -> None:
        acts = to_float64(acts)
        logits = to_float64(logits)
        self.count += len(acts)
        self.act_sum += acts.sum(axis=0)
        self.act_outer += acts.T @ acts
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        splits = np.asarray(global_indices) // self.split_size
        np.add.at(self.split_count, splits, 1)
        np.add.at(self.split_plogp, splits, np.sum(probs * np.log(probs), axis=-1))
        np.add.at(self.split_prob_sum, splits, probs)

    def state(self) -> dict:
        out = {name: getattr(self, name) for name in self._ARRAYS}
        out["count"] = np.asarray(self.count, np.int64)
        return out

    def merge_state(self, state: dict) -> None:
        self.count += int(state["count"])
        for name in self._ARRAYS:
            getattr(self, name).__iadd__(np.asarray(state[name]))

    def merge_across_hosts(self) -> None:
        """Nothing to merge in one process (raises under torch.distributed)."""
        refuse_distributed("AdmMomentAccumulator.merge_across_hosts")

    def fid_statistics(self) -> FIDStatistics:
        mu = self.act_sum / self.count
        # the unbiased covariance, np.cov(acts, rowvar=False)
        sigma = get_covariance(self.act_outer, self.act_sum, self.count)
        return FIDStatistics(mu, sigma)

    def inception_score(self) -> float:
        scores = []
        for k in range(len(self.split_count)):
            n = int(self.split_count[k])
            if n == 0:
                continue
            pbar = self.split_prob_sum[k] / n
            kl = self.split_plogp[k] / n - float(np.sum(pbar * np.log(pbar)))
            scores.append(np.exp(kl))
        return float(np.mean(scores))
