"""The port's public API: each of the eight subpackages whose JAX
``__init__.py`` re-exports names (optimization, models, utils, ops,
algorithm, estimators, projector, data) exports every name of JAX's
``__all__`` (read by AST from the JAX file, not imported), each an object
of the port, and the JAX list in the same order. The public names the
port's modules lacked are held against their JAX functions where they
compute something: ``OptimizerConfig``, ``no_normalization``,
``filter_features_by_support``, the two down-samplers, the
``constants.py`` tolerances, ``diagnostics.CoefficientSummary`` and
``algorithm.LazyTrackers``. The packages whose modules torch-free
processes import (``data``, ``utils``) import no torch."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("optimization", "models", "utils", "ops", "algorithm",
            "estimators", "projector", "data")
# Exported by the port beyond JAX's list (ported in the fused update).
EXTRA = {"algorithm": ["LazyTrackers"]}


def _jax_exports(pkg: str):
    """([(module, name)] JAX's __init__ imports, its __all__ or None) by
    AST."""
    tree = ast.parse((REPO / "photon_ml_tpu" / pkg / "__init__.py")
                     .read_text())
    imported, listed = [], None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            imported += [(node.module, a.name) for a in node.names]
        elif (isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", "") == "__all__"):
            listed = [e.value for e in node.value.elts]
    return imported, listed


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_jax_names(pkg):
    imported, listed = _jax_exports(pkg)
    port = importlib.import_module(f"photon_ml_tpu_torch.{pkg}")
    if listed is None:  # data: JAX's package exports nothing
        assert imported == []
        assert getattr(port, "__all__", []) == []
        return
    assert port.__all__ == listed + EXTRA.get(pkg, [])
    assert set(listed) <= {name for _, name in imported}
    for module, name in imported:
        # The port's namesake module defines the same name.
        twin = importlib.import_module(
            module.replace("photon_ml_tpu", "photon_ml_tpu_torch", 1))
        assert getattr(port, name) is getattr(twin, name), (pkg, name)
    # The names import as a user writes them.
    exec(f"from photon_ml_tpu_torch.{pkg} import {', '.join(listed)}", {})


def test_torch_free_packages_import_no_torch():
    code = ("import sys, photon_ml_tpu_torch.data, photon_ml_tpu_torch.utils;"
            " assert 'torch' not in sys.modules, 'torch'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=60)


def test_optimizer_config_matches_jax():
    from photon_ml_tpu.optimization import config as jax_config
    from photon_ml_tpu_torch.optimization import OptimizerConfig, OptimizerType

    for kind in ("LBFGS", "TRON"):
        for kw in ({}, {"max_iterations": 7, "tolerance": 1e-3,
                        "constraint_map": {0: (-1.0, 2.0), 3: (0.0, 5.0)}}):
            ours = OptimizerConfig(OptimizerType(kind), **kw)
            theirs = jax_config.OptimizerConfig(
                jax_config.OptimizerType(kind), **kw)
            assert ours.to_json() == theirs.to_json()
            r, t = ours.resolved(), theirs.resolved()
            assert (r.max_iterations, r.tolerance) == (t.max_iterations,
                                                       t.tolerance)
            assert OptimizerConfig.from_json(ours.to_json()).to_json() \
                == ours.to_json()
    for bad in ({"max_iterations": 0}, {"tolerance": -1.0}):
        with pytest.raises(ValueError):
            OptimizerConfig(**bad)
        with pytest.raises(ValueError):
            jax_config.OptimizerConfig(**bad)


def test_constants_match_jax():
    from photon_ml_tpu import constants as jax_constants
    from photon_ml_tpu_torch import constants

    public = [n for n in vars(jax_constants) if n.isupper()]
    assert {"HIGH_PRECISION_TOLERANCE", "MEDIUM_PRECISION_TOLERANCE",
            "LOW_PRECISION_TOLERANCE", "EPSILON"} <= set(public)
    for name in public:
        assert getattr(constants, name) == getattr(jax_constants, name)


def test_no_normalization_matches_jax():
    from photon_ml_tpu.data.normalization import (
        no_normalization as jax_none,
    )
    from photon_ml_tpu_torch.data.normalization import no_normalization

    ours, theirs = no_normalization(), jax_none()
    assert (ours.factors, ours.shifts, ours.intercept_id) == (
        theirs.factors, theirs.shifts, theirs.intercept_id) == (None, None,
                                                                -1)
    coef = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    assert torch.equal(ours.effective_coefficients(coef), coef)
    assert torch.equal(ours.model_to_original_space(coef), coef)


@pytest.mark.parametrize("intercept", [None, 4, 9])
def test_filter_features_by_support_matches_jax(intercept):
    from photon_ml_tpu.data.random_effect import (
        filter_features_by_support as jax_filter,
    )
    from photon_ml_tpu_torch.data.random_effect import (
        filter_features_by_support,
    )

    x = sp.random(30, 10, density=0.2, random_state=3, format="csr")
    for k in (0, 1, 3, 6, 31):
        ours = filter_features_by_support(x, k, intercept)
        theirs = jax_filter(x, k, intercept)
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == theirs.dtype


def test_down_samplers():
    """The JAX samplers draw with jax.random, the port's with a
    torch.Generator, so their masks differ: they are equal at rate 1 and
    keep the same contract below it (kept rows rescaled by exactly
    1/rate, dropped rows 0, positives untouched by the classification
    sampler). down_sample_weights picks between them as JAX's does."""
    import jax

    from photon_ml_tpu.data import sampling as jax_sampling
    from photon_ml_tpu_torch.data.sampling import (
        binary_classification_down_sampler,
        default_down_sampler,
        down_sample_weights,
    )

    rng = np.random.default_rng(0)
    n = 4000
    w = rng.uniform(0.5, 2.0, n)
    y = (rng.random(n) < 0.3).astype(float)
    key = jax.random.PRNGKey(0)
    tw, ty = torch.as_tensor(w), torch.as_tensor(y)

    def gen():
        return torch.Generator().manual_seed(5)

    np.testing.assert_array_equal(
        default_down_sampler(gen(), tw, 1.0).numpy(),
        np.asarray(jax_sampling.default_down_sampler(key, jnp.asarray(w),
                                                     1.0)))
    np.testing.assert_array_equal(
        binary_classification_down_sampler(gen(), ty, tw, 1.0).numpy(),
        np.asarray(jax_sampling.binary_classification_down_sampler(
            key, jnp.asarray(y), jnp.asarray(w), 1.0)))
    rate = 0.25
    d = default_down_sampler(gen(), tw, rate).numpy()
    kept = d != 0
    np.testing.assert_array_equal(d[kept], w[kept] / rate)
    assert abs(kept.mean() - rate) < 0.03
    b = binary_classification_down_sampler(gen(), ty, tw, rate).numpy()
    pos = y >= 0.5
    np.testing.assert_array_equal(b[pos], w[pos])
    np.testing.assert_array_equal(b[~pos], d[~pos])
    assert torch.equal(down_sample_weights(gen(), ty, tw, rate, True),
                       torch.as_tensor(b))
    assert torch.equal(down_sample_weights(gen(), ty, tw, rate, False),
                       torch.as_tensor(d))
    assert down_sample_weights(gen(), ty, tw, 1.0, True) is tw


def test_coefficient_summary_matches_jax():
    from photon_ml_tpu.diagnostics import (
        CoefficientSummary as JaxSummary,
    )
    from photon_ml_tpu_torch.diagnostics import CoefficientSummary
    from photon_ml_tpu_torch.models import (
        CoefficientSummary as ModelsSummary,
    )

    assert CoefficientSummary is ModelsSummary
    values = np.random.default_rng(1).normal(size=11).tolist()
    ours, theirs = CoefficientSummary.of(values), JaxSummary.of(values)
    for attr in ("count", "mean", "min", "max", "variance", "std_dev"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    for fn in ("first_quartile", "median", "third_quartile"):
        assert getattr(ours, fn)() == getattr(theirs, fn)(), fn


def test_lazy_trackers_is_the_fused_runs_type():
    from photon_ml_tpu_torch.algorithm import LazyTrackers
    from photon_ml_tpu_torch.algorithm import coordinate_descent

    assert LazyTrackers is coordinate_descent.LazyTrackers
