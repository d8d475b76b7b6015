"""Distribution monitoring on the card: the serving engine's score
monitor, fed at settle from card-scored buckets, holds the same quantile
sketch state bit for bit for ``score_many`` and ``score_stream`` over
the same rows (a row's bits do not depend on its bucket, and the
quantile sketch is multiset-determined), with the same moments' count,
nnz, min and max and the mean within 1e-12 of the mean |score| (the
moments sum each flush in the order the rows settled, and
``score_many`` settles a request too large for one bucket before the
groups still in flight ahead of it); and the resident
``--stream-train --distmon`` run's training-score sketch (one row-9
product of the assembled batch on the card, float32) has the median of
the plain float64 CPU product of the saved model on the same rows within
5% (JAX's tolerance between its two score surfaces,
tests/test_distmon.py:378-389), with the same count.

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package:

    python -m pytest --noconftest -q tests/test_torch_distmon_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.cli import game_training_driver
from photon_ml_tpu_torch.data.avro_reader import read_game_dataset
from photon_ml_tpu_torch.data.distmon import ScoreDistributionMonitor
from photon_ml_tpu_torch.data.paldb import load_feature_index_maps
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.telemetry.sketches import QuantileSketch
from test_torch_serving_cuda import engine, model, request
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the buckets score on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed", "random", "mf"])
def test_score_monitor_same_state_for_score_many_and_score_stream(
        cuda_device, kind):
    gm = model(kind)
    reqs = [request(300 + i, n) for i, n in
            enumerate([1, 7, 40, 100, 3, 256, 64, 300, 19])]
    states, moments = [], []
    for run in ("many", "stream"):
        eng = engine(gm)
        eng.score_monitor = ScoreDistributionMonitor("default")
        got = (eng.score_many(reqs) if run == "many"
               else list(eng.score_stream(reqs)))
        assert sum(len(s) for s in got) == sum(r.num_rows for r in reqs)
        states.append(eng.score_monitor.sketch_states())
        moments.append(eng.stats()["score_distribution"]["scores"][
            "moments"])
        assert moments[-1]["count"] == sum(r.num_rows for r in reqs)
    assert states[0]["default.scores.quantiles"] \
        == states[1]["default.scores.quantiles"]
    a, b = (s["default.scores.moments"] for s in states)
    assert all(a[k] == b[k] for k in ("count", "nnz", "min", "max"))
    assert abs(moments[0]["mean"] - moments[1]["mean"]) \
        <= 1e-12 * moments[1]["abs_mean"]


def _write(path, n=600, d=40, per_row=5, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, d)
    records = []
    for i in range(n):
        idx = rng.choice(d, size=per_row, replace=False)
        vals = rng.normal(0, 1, per_row)
        z = float(vals @ w[idx])
        records.append({
            "uid": f"u{i}", "label": float(rng.random() < 1 / (1 + np.exp(
                -z))),
            "features": [{"name": f"f{j}", "term": None, "value": float(v)}
                         for j, v in zip(idx, vals)],
            "weight": None, "offset": None, "metadataMap": None})
    path.mkdir(parents=True)
    write_container(path / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    records)


@pytest.mark.cuda
def test_resident_training_scores_match_plain_cpu_product(cuda_device,
                                                          tmp_path):
    train = tmp_path / "train"
    _write(train)
    out = tmp_path / "out"
    summary = game_training_driver.run([
        "--train-input-dirs", str(train), "--output-dir", str(out),
        "--task-type", "LOGISTIC_REGRESSION",
        "--fixed-effect-data-configurations", "fixed:global",
        "--fixed-effect-optimization-configurations",
        "fixed:25,1e-7,1.0,1.0,LBFGS,L2", "--updating-sequence", "fixed",
        "--stream-train", "--batch-rows", "64", "--distmon"])
    assert summary["stream_train"]["mode"] == "resident-assembled"
    best = out / "best"
    ref = json.loads((best / "model-metadata.json").read_text())[
        "referenceDistributions"]
    card = QuantileSketch.from_state(ref["score"])
    maps = load_feature_index_maps(best / "feature-indexes")
    data, _ = read_game_dataset([str(train)], id_types=[],
                                feature_shard_maps=maps)
    gm = load_game_model(best, maps)
    w = np.asarray(gm.models["fixed"].glm.coefficients.means, np.float64)
    plain = QuantileSketch(card.relative_accuracy)
    plain.update(data.feature_shards["global"] @ w)
    assert card.count == plain.count == 600
    m_card, m_plain = card.quantile(0.5), plain.quantile(0.5)
    assert abs(m_card - m_plain) <= 0.05 * abs(m_plain)
