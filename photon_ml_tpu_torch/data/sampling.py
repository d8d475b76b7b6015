"""Samplers (port of photon_ml_tpu/data/sampling.py: reservoir_sample :26,
default_down_sampler :43, binary_classification_down_sampler :52,
down_sample_weights :63).

- ``reservoir_sample`` caps an entity's rows on the host at ingest; it is
  numpy, so the same seed picks the same rows as the JAX package.
- the down-samplers fold a Bernoulli keep-mask into the weights and
  rescale survivors by 1/rate (ml/sampler/*.scala). The mask comes from
  an explicit ``torch.Generator``; it cannot reproduce ``jax.random``'s
  bits, so only its rate is comparable across the two packages. At rate
  1.0 it is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def reservoir_sample(rng: np.random.Generator, n: int, cap: int
                     ) -> tuple:
    """Pick ``cap`` of ``n`` rows uniformly; survivors' weights scale by
    n/cap (ml/data/RandomEffectDataSet.scala:299-310). Returns (sorted
    selected indices, weight multiplier)."""
    if n <= cap:
        return np.arange(n), 1.0
    idx = rng.choice(n, size=cap, replace=False)
    idx.sort()
    return idx, n / cap


def default_down_sampler(generator: torch.Generator, weights: Tensor,
                         rate: float) -> Tensor:
    """Keep each row with probability ``rate``, rescale kept weights by
    1/rate (ml/sampler/DefaultDownSampler.scala:27-45)."""
    u = torch.rand(weights.shape, generator=generator, dtype=weights.dtype,
                   device=weights.device)
    return torch.where(u < rate, weights / rate, torch.zeros_like(weights))


def binary_classification_down_sampler(generator: torch.Generator,
                                       labels: Tensor, weights: Tensor,
                                       rate: float) -> Tensor:
    """Down-sample negatives only, rescaling their weights
    (ml/sampler/BinaryClassificationDownSampler.scala:32-60)."""
    kept = default_down_sampler(generator, weights, rate)
    return torch.where(labels < 0.5, kept, weights)


def down_sample_weights(generator: torch.Generator, labels: Tensor,
                        weights: Tensor, rate: float,
                        is_classification: bool) -> Tensor:
    """The down-sampler the reference selects
    (ml/optimization/DistributedOptimizationProblem.scala:165-176):
    classification down-samples negatives only, other tasks every row."""
    if rate >= 1.0:
        return weights
    if is_classification:
        return binary_classification_down_sampler(generator, labels,
                                                  weights, rate)
    return default_down_sampler(generator, weights, rate)
