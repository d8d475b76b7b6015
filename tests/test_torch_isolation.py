"""The port stands alone: no module of photon_ml_tpu_torch/ (nor
chip_smoke.py) imports jax or anything of the photon_ml_tpu package, and
its entry points refuse to run when CUDA is absent unless the caller
passes device="cpu"."""

import ast
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((REPO / "photon_ml_tpu_torch").rglob("*.py"))
    smoke = REPO / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    scanned = {p.relative_to(REPO).parts[1] for p in files
               if p.parent != REPO}
    assert {"projector", "dev_scripts", "ops", "models", "io", "cli",
            "utils", "diagnostics", "estimators", "evaluation", "native",
            "serving", "data", "optimization", "algorithm"} <= scanned
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "photon_ml_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def _gpu_less(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _dataset():
    from photon_ml_tpu_torch.data.game_data import GameDataset

    rng = np.random.default_rng(0)
    return GameDataset.build(
        responses=(rng.random(20) < 0.5).astype(float),
        feature_shards={"g": sp.csr_matrix(rng.normal(0, 1, (20, 3)))},
        ids={"u": rng.integers(0, 4, 20).astype(str)})


@pytest.mark.parametrize("entry", [
    "estimator", "fixed_effect_batch", "random_effect_dataset",
    "coordinate", "coordinate_descent", "convert", "features",
    "gather_experiments", "matrix_factorization", "training_driver",
    "scoring_driver", "glm_driver", "train_glm_models", "device_batch",
    "stream_training_driver", "shard_cache", "assemble_fixed_effect_batch",
    "chunked_device_put", "streaming_scorer", "serving_frontend",
    "stream_scoring_driver", "serve_scoring_driver",
    "listen_scoring_driver", "make_mesh", "mesh_training_driver"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           entry):
    from photon_ml_tpu_torch.algorithm.coordinate_descent import (
        CoordinateDescent,
    )
    from photon_ml_tpu_torch.algorithm.coordinates import (
        FixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.cli import (
        game_scoring_driver,
        game_training_driver,
        glm_driver,
    )
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.data.device_feed import chunked_device_put
    from photon_ml_tpu_torch.parallel import make_mesh
    from photon_ml_tpu_torch.data.shard_cache import (
        DeviceShardCache,
        assemble_fixed_effect_batch,
    )
    from photon_ml_tpu_torch.dev_scripts import gather_experiments
    from photon_ml_tpu_torch.estimators import model_training
    from photon_ml_tpu_torch.estimators.game_estimator import (
        FixedEffectSpec,
        GameEstimator,
    )
    from photon_ml_tpu_torch.models.game_model import GameModel
    from photon_ml_tpu_torch.models.matrix_factorization import (
        MatrixFactorizationModel,
    )
    from photon_ml_tpu_torch.ops.features import features_to_device
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
    )
    from photon_ml_tpu_torch.serving.engine import StreamingGameScorer
    from photon_ml_tpu_torch.serving.frontend import ServingFrontend
    from photon_ml_tpu_torch.types import TaskType

    _gpu_less(monkeypatch)
    data = _dataset()
    task = TaskType.LOGISTIC_REGRESSION
    cfg = GLMOptimizationConfiguration()
    calls = {
        "estimator": lambda: GameEstimator(
            task, [FixedEffectSpec("f", "g", [cfg])]),
        "fixed_effect_batch": lambda: data.fixed_effect_batch("g"),
        "random_effect_dataset": lambda: build_random_effect_dataset(
            data, RandomEffectDataConfiguration("u", "g")),
        "coordinate": lambda: FixedEffectCoordinate(
            "f", data, "g", task, cfg),
        "coordinate_descent": lambda: CoordinateDescent(
            {"f": FixedEffectCoordinate("f", data, "g", task, cfg,
                                        device="cpu")}, task),
        "convert": lambda: game_model_from_numpy(task, {}),
        "features": lambda: features_to_device(data.feature_shards["g"]),
        "gather_experiments": lambda: gather_experiments.main(["--check"]),
        "matrix_factorization": lambda: MatrixFactorizationModel.random(
            "u", "i", ["a"], ["b"], num_factors=2),
        "training_driver": lambda: game_training_driver.run([
            "--train-input-dirs", "train", "--output-dir", "out",
            "--task-type", "LOGISTIC_REGRESSION",
            "--updating-sequence", "fixed"]),
        "scoring_driver": lambda: game_scoring_driver.run([
            "--input-dirs", "data", "--game-model-input-dir", "model",
            "--output-dir", "out"]),
        "glm_driver": lambda: glm_driver.run([
            "--training-data-directory", "train", "--output-directory",
            "out", "--task", "LOGISTIC_REGRESSION"]),
        "train_glm_models": lambda: model_training.train_glm_models(
            data.feature_shards["g"], data.responses, task, [1.0]),
        "device_batch": lambda: model_training.device_batch(
            data.feature_shards["g"], data.responses),
        "stream_training_driver": lambda: game_training_driver.run([
            "--train-input-dirs", "train", "--output-dir", "out",
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:g",
            "--updating-sequence", "fixed", "--stream-train",
            "--hbm-budget", "8K"]),
        "shard_cache": lambda: DeviceShardCache.from_stream([data], "g"),
        "assemble_fixed_effect_batch": lambda: assemble_fixed_effect_batch(
            [data], "g"),
        "chunked_device_put": lambda: chunked_device_put(data.responses),
        "streaming_scorer": lambda: StreamingGameScorer(
            GameModel({}, task)),
        "serving_frontend": lambda: ServingFrontend(
            {"default": GameModel({}, task)}),
        "stream_scoring_driver": lambda: game_scoring_driver.run([
            "--input-dirs", "data", "--game-model-input-dir", "model",
            "--output-dir", "out", "--stream"]),
        "serve_scoring_driver": lambda: game_scoring_driver.run([
            "--input-dirs", "data", "--game-model-input-dir", "model",
            "--output-dir", "out", "--serve"]),
        "listen_scoring_driver": lambda: game_scoring_driver.run([
            "--input-dirs", "data", "--game-model-input-dir", "model",
            "--output-dir", "out", "--listen", "0", "--adaptive-admission",
            "--slo", "p99:x<=1ms"]),
        "make_mesh": lambda: make_mesh(2),
        "mesh_training_driver": lambda: game_training_driver.run([
            "--train-input-dirs", "train", "--output-dir", "out",
            "--task-type", "LOGISTIC_REGRESSION",
            "--fixed-effect-data-configurations", "fixed:g",
            "--updating-sequence", "fixed", "--stream-train",
            "--hbm-budget", "8K", "--mesh-devices", "2"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_scorer_raises_without_cuda(monkeypatch):
    from photon_ml_tpu_torch.models.device_scoring import DeviceGameScorer
    from photon_ml_tpu_torch.models.game_model import GameModel
    from photon_ml_tpu_torch.types import TaskType

    _gpu_less(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceGameScorer(GameModel({}, TaskType.LOGISTIC_REGRESSION),
                         _dataset())


def test_glm_driver_runs_on_the_cpu_only_when_asked(monkeypatch, tmp_path):
    """device="cpu" trains without CUDA (the CPU tests' route); the
    default refuses before it reads anything."""
    from photon_ml_tpu_torch.cli import glm_driver

    _gpu_less(monkeypatch)
    f = tmp_path / "train" / "data.libsvm"
    f.parent.mkdir()
    f.write_text("1 1:0.5 2:1\n0 1:-1 2:0.25\n1 1:2\n0 2:-0.5\n")
    argv = ["--training-data-directory", str(f.parent),
            "--output-directory", str(tmp_path / "out"),
            "--task", "LOGISTIC_REGRESSION", "--format", "LIBSVM",
            "--max-num-iterations", "3"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        glm_driver.run(argv)
    assert not (tmp_path / "out").exists()
    summary = glm_driver.run(argv, device="cpu")
    assert summary["stages"] == ["INIT", "PREPROCESSED", "TRAINED"]
