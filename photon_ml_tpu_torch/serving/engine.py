"""Scoring of arbitrary GameDatasets against one frozen GameModel (port of
photon_ml_tpu/serving/engine.py: StreamingGameScorer, its construction
:175- and ``score(data)`` :557).

Streamed validation (``--stream-train``) scores each decoded batch
against every model of the λ grid. A batch's entity vocabularies are its
own, and the scorer joins them to the model's by entity NAME, as the
device scorer does (models/device_scoring.py). The JAX engine's bucket
ladder, executable cache, dispatch pipelining, micro-batching and
per-model metrics are ROADMAP A5.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer
from photon_ml_tpu_torch.models.game_model import GameModel


class StreamingGameScorer:
    """Scores GameDatasets against ONE GameModel on ``device``, in
    ``dtype`` (float32 on the card; float64 for the CPU parity tests)."""

    def __init__(self, model: GameModel, dtype=torch.float32,
                 device="cuda"):
        self.model = model
        self.dtype = dtype
        self.device = resolve_device(device)

    def score(self, data) -> np.ndarray:
        """Host [n_rows] model margins of one dataset (no offsets: the
        GameModel.score contract)."""
        scorer = DeviceGameScorer(self.model, data, dtype=self.dtype,
                                  device=self.device)
        return scorer.score(self.model).cpu().numpy()
