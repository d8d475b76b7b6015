"""The port's copies of the GLM driver's host modules against the JAX
package's, on the same arrays (numpy, seeded), rtol 1e-12: every
diagnostic (Kendall tau, prediction-error independence, Hosmer-Lemeshow,
both feature importances, the fitting curves and bootstrap intervals with
one shared trainer), the report's JSON and rendered HTML, evaluate_glm
and select_best_model, read_libsvm and validate_data."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu import diagnostics as jax_diag
from photon_ml_tpu.data import libsvm as jax_libsvm
from photon_ml_tpu.data import validators as jax_validators
from photon_ml_tpu.data.stats import BasicStatisticalSummary as JaxSummary
from photon_ml_tpu.diagnostics import reporting as jax_reporting
from photon_ml_tpu.estimators import model_selection as jax_selection
from photon_ml_tpu.evaluation import validation as jax_validation
from photon_ml_tpu.models.coefficients import Coefficients as JaxCoef
from photon_ml_tpu.models.glm import LogisticRegressionModel as JaxLR
from photon_ml_tpu.types import DataValidationType as JaxDVT
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch import diagnostics
from photon_ml_tpu_torch.data import libsvm, validators
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.diagnostics import reporting
from photon_ml_tpu_torch.estimators import model_selection
from photon_ml_tpu_torch.evaluation import validation
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import LogisticRegressionModel
from photon_ml_tpu_torch.types import DataValidationType, TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

RTOL = 1e-12


def _close(a, b, path="$"):
    """Equal structure and strings; numbers within RTOL."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, (bool, str)) or b is None:
        assert a == b, (path, a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=path)


def _data(seed=11, n=420, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.0, (n, d))
    x[:, -1] = 1.0
    w = rng.normal(0, 1, d)
    p = 1 / (1 + np.exp(-x @ w))
    y = (rng.random(n) < p).astype(np.float64)
    return x, y, p


def test_kendall_tau_and_independence_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=300)
    b = 0.3 * a + rng.normal(size=300)
    b[::7] = b[0]  # ties
    _close(diagnostics.kendall_tau_analysis(a, b).to_dict(),
           jax_diag.kendall_tau_analysis(a, b).to_dict())
    x, y, p = _data(n=5200)  # past the 5,000-row sample: the same draw
    got = diagnostics.prediction_error_independence(y, p, seed=3)
    want = jax_diag.prediction_error_independence(y, p, seed=3)
    np.testing.assert_array_equal(got.predictions, want.predictions)
    _close(got.to_dict(), want.to_dict())


@pytest.mark.parametrize("num_bins", [None, 7])
def test_hosmer_lemeshow_matches_jax(num_bins):
    _, y, p = _data()
    _close(diagnostics.hosmer_lemeshow_diagnostic(y, p, 6,
                                                  num_bins).to_dict(),
           jax_diag.hosmer_lemeshow_diagnostic(y, p, 6, num_bins).to_dict())


def test_feature_importances_match_jax():
    x, _, _ = _data()
    mat = sp.csr_matrix(x)
    coef = np.random.default_rng(2).normal(size=x.shape[1])
    names = [f"f{j}" for j in range(x.shape[1])]
    summ, jsumm = BasicStatisticalSummary.compute(mat), JaxSummary.compute(mat)
    for name in ("expected_magnitude_importance", "variance_importance"):
        for s, js in ((summ, jsumm), (None, None)):
            _close(getattr(diagnostics, name)(coef, s, names).to_dict(),
                   getattr(jax_diag, name)(coef, js, names).to_dict())


def _trainer(model_cls, coef_cls, evaluate, task, x, y,
             lambdas=(1.0, 0.1)):
    """A λ-grid trainer in the shape fitting/bootstrap take: ridge-like
    closed-form coefficients (numpy) on the training rows, warm start
    ignored, both splits scored by the package's evaluate_glm."""
    def train(train_idx, holdout_idx, warm):
        out = []
        xt, yt = x[train_idx], y[train_idx]
        for lam in lambdas:
            w = np.linalg.solve(xt.T @ xt + lam * np.eye(x.shape[1]),
                                xt.T @ (2 * yt - 1))
            out.append((lam, model_cls(coef_cls(w)),
                        evaluate(task, xt @ w, yt),
                        evaluate(task, x[holdout_idx] @ w, y[holdout_idx])))
        return out
    return train


def _reports(x, y):
    port = _trainer(LogisticRegressionModel,
                    lambda w: Coefficients(torch.as_tensor(w)),
                    validation.evaluate_glm, TaskType.LOGISTIC_REGRESSION,
                    x, y)
    ref = _trainer(JaxLR, lambda w: JaxCoef(np.asarray(w)),
                   jax_validation.evaluate_glm, JaxTask.LOGISTIC_REGRESSION,
                   x, y)
    fit = diagnostics.fitting_diagnostic(x.shape[0], x.shape[1], port)
    jfit = jax_diag.fitting_diagnostic(x.shape[0], x.shape[1], ref)

    def boot(trainer):
        return lambda tr, ho, warm: [(lam, m, hold) for lam, m, _, hold
                                     in trainer(tr, ho, warm)]

    bs = diagnostics.bootstrap_training(x.shape[0], boot(port), 4)
    jbs = jax_diag.bootstrap_training(x.shape[0], boot(ref), 4)
    return fit, jfit, bs, jbs


def test_fitting_and_bootstrap_match_jax():
    x, y, _ = _data()
    fit, jfit, bs, jbs = _reports(x, y)
    assert sorted(fit) == sorted(jfit) == [0.1, 1.0]
    for lam in fit:
        _close(fit[lam].to_dict(), jfit[lam].to_dict())
        _close(bs[lam].to_dict(), jbs[lam].to_dict())
        assert bs[lam].num_models == 4
    assert diagnostics.fitting_diagnostic(10, 6, None) == {}


def test_report_json_and_html_match_jax(tmp_path):
    x, y, p = _data()
    fit, jfit, bs, jbs = _reports(x, y)
    mat = sp.csr_matrix(x)
    coef = np.linspace(-1, 1, x.shape[1])
    names = [f"f{j}" if j < x.shape[1] - 1 else "(INTERCEPT)"
             for j in range(x.shape[1])]
    docs = []
    for diag, rep, summ, mode in (
            (diagnostics, reporting, BasicStatisticalSummary.compute(mat),
             diagnostics.DiagnosticMode.ALL),
            (jax_diag, jax_reporting, JaxSummary.compute(mat),
             jax_diag.DiagnosticMode.ALL)):
        this_fit, this_bs = (fit, bs) if diag is diagnostics else (jfit,
                                                                   jbs)
        report = diag.DiagnosticReport(system={
            "task": "LOGISTIC_REGRESSION", "numRows": x.shape[0],
            "numFeatures": x.shape[1], "lambdas": [1.0, 0.1],
            "diagnosticMode": mode.value})
        for lam in (1.0, 0.1):
            chapter = rep.ModelDiagnosticReport(
                model_description="LogisticRegressionModel", reg_weight=lam,
                metrics={"AUC": 0.75})
            chapter.feature_importance = [
                diag.expected_magnitude_importance(coef, summ,
                                                   names).to_dict(),
                diag.variance_importance(coef, summ, names).to_dict()]
            chapter.fitting = this_fit[lam].to_dict()
            chapter.bootstrap = this_bs[lam].to_dict()
            chapter.prediction_error_independence = \
                diag.prediction_error_independence(y, p).to_dict()
            chapter.hosmer_lemeshow = diag.hosmer_lemeshow_diagnostic(
                y, p, x.shape[1]).to_dict()
            report.models.append(chapter)
        out = tmp_path / diag.__name__
        diag.write_report(report, out)
        docs.append((json.loads((out / "model-diagnostic.json").read_text()),
                     diag.render_html_report(report),
                     (out / "model-diagnostic.html").read_text()))
    (pj, ph, pf), (jj, jh, jf) = docs
    _close(pj, jj)
    assert ph == jh and pf == jf
    assert "<svg" in ph


def test_evaluate_glm_and_selection_match_jax():
    x, y, _ = _data()
    rng = np.random.default_rng(4)
    off, wt = rng.normal(0, 0.1, len(y)), rng.uniform(0.5, 2, len(y))
    scored = {lam: x @ rng.normal(0, 1, x.shape[1])
              for lam in (10.0, 1.0, 0.1)}
    counts = rng.poisson(2.0, len(y)).astype(float)
    for task in TaskType:
        labels = counts if task == TaskType.POISSON_REGRESSION else y
        jtask = JaxTask(task.value)
        for lam, s in scored.items():
            _close(validation.evaluate_glm(task, s, labels, off, wt, 6),
                   jax_validation.evaluate_glm(jtask, s, labels, off, wt, 6))
        got = model_selection.select_best_model(task, scored, labels, off,
                                                wt)
        want = jax_selection.select_best_model(jtask, scored, labels, off,
                                               wt)
        assert got[0] == want[0]
        _close(got[1], want[1])
        assert type(model_selection.selection_evaluator(task)).__name__ == \
            type(jax_selection.selection_evaluator(jtask)).__name__


def test_read_libsvm_and_validate_data_match_jax(tmp_path):
    f = tmp_path / "data.libsvm"
    f.write_text("# header\n1 1:0.5 3:-2\n-1 2:1.25  # note\n\n"
                 "1 4:3e-1 1:7\n-1\n")
    for kw in ({}, {"add_intercept": False}, {"num_features": 6},
               {"map_negative_labels": False}, {"zero_based": True}):
        (m, y), (jm, jy) = (libsvm.read_libsvm(f, **kw),
                            jax_libsvm.read_libsvm(f, **kw))
        assert (m != jm).nnz == 0 and m.shape == jm.shape
        np.testing.assert_array_equal(y, jy)
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 1:0.5\n1 0:2\n")
    with pytest.raises(ValueError) as err:
        libsvm.read_libsvm(bad)
    with pytest.raises(ValueError) as jerr:
        jax_libsvm.read_libsvm(bad)
    assert str(err.value) == str(jerr.value)

    x, y, _ = _data(n=40)
    y = y.copy()
    # Rows 10, 20 and 30: VALIDATE_SAMPLE (every 10th row) sees them.
    y[10] = 2.0
    x[20, 1] = np.nan
    wt = np.ones(len(y))
    wt[30] = -1.0
    for task in TaskType:
        for vt in DataValidationType:
            args = (x, y, np.zeros(len(y)), wt)
            got = want = None
            try:
                validators.validate_data(task, *args, vt)
            except ValueError as e:
                got = str(e)
            try:
                jax_validators.validate_data(JaxTask(task.value), *args,
                                             JaxDVT(vt.value))
            except ValueError as e:
                want = str(e)
            assert got == want, (task, vt)
            assert (got is None) == (vt == DataValidationType
                                     .VALIDATE_DISABLED), (task, vt)
