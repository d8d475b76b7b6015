"""The port's GLM driver against the JAX package's, float64 on the CPU,
both in this process (``run(argv, device="cpu")`` for the port), on
Avro data from examples/generate_example_data.glm_records and LIBSVM
text (a few hundred rows):

- examples/run_glm_driver.sh's flags with --diagnostic-mode ALL: equal
  stages, λ list, best λ, iterations and reasons, final objectives
  within rtol 1e-10; validation-metrics.json within rtol 1e-9; model.txt
  (best and every λ) with equal names, terms and λ and values within
  atol 1e-8; model.avro's decoded means and variances within atol 1e-8;
  model-diagnostic.json with equal keys and strings and numbers within
  rtol 1e-8;
- --format LIBSVM with TRON on linear regression, and Poisson; OWL-QN
  with ELASTIC_NET; box constraints; --selected-features-file with
  --summarization-output-dir (records equal); --offheap-indexmap-dir with
  a JSON store;
- --validate-data rejecting bad labels with the same message, and
  --profile-output-dir writing a profiler trace of the train phase.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.cli import glm_driver as jax_glm
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_container, write_container
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

EXAMPLE_FLAGS = [  # examples/run_glm_driver.sh, every diagnostic
    "--task", "LOGISTIC_REGRESSION",
    "--format", "AVRO",
    "--max-num-iterations", "80",
    "--regularization-weights", "100,10,1,0.1",
    "--regularization-type", "L2",
    "--optimizer", "LBFGS",
    "--normalization-type", "STANDARDIZATION",
    "--diagnostic-mode", "ALL",
    "--compute-variance", "true",
    "--dtype", "float64",
]


def _generator():
    spec = importlib.util.spec_from_file_location(
        "generate_example_data", REPO / "examples" / "generate_example_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path: Path, records) -> Path:
    path.mkdir(parents=True)
    write_container(path / "part-00000.avro", schemas.TRAINING_EXAMPLE,
                    records)
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """glm_records train / validate directories (8 features), plus a
    LIBSVM linear-regression set and a LIBSVM Poisson set."""
    root = tmp_path_factory.mktemp("glm_data")
    gen = _generator()
    rng = np.random.default_rng(23)
    w = rng.normal(0, 1, 9)
    out = {"root": root,
           "train": _write(root / "train", gen.glm_records(rng, 300, w)),
           "validate": _write(root / "validate",
                              gen.glm_records(rng, 100, w))}
    for name, poisson in (("linear", False), ("poisson", True)):
        wl = rng.normal(0, 0.5, 4)
        lines = []
        for _ in range(160):
            x = rng.normal(0, 1, 4)
            z = x @ wl
            y = (rng.poisson(np.exp(z)) if poisson
                 else z + rng.normal(0, 0.1))
            feats = " ".join(f"{j + 1}:{x[j]:.5f}" for j in range(4))
            lines.append(f"{y:.5f} {feats}")
        d = root / name
        d.mkdir()
        (d / "data.libsvm").write_text("\n".join(lines) + "\n")
        out[name] = d
    return out


def _run_both(out: Path, flags):
    """Both drivers on one command line; returns their summaries and
    output directories."""
    port = glm_driver.run([*flags, "--output-directory", str(out / "port")],
                          device="cpu")
    jax = jax_glm.run([*flags, "--output-directory", str(out / "jax")])
    return {"port": (port, out / "port"), "jax": (jax, out / "jax")}


def _text_model(path: Path):
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    return ([(r[0], r[1], r[3]) for r in rows],
            np.asarray([float(r[2]) for r in rows]))


def _assert_same_run(runs):
    (ps, pdir), (js, jdir) = runs["port"], runs["jax"]
    for key in ("jobName", "task", "stages", "numRows", "numFeatures",
                "lambdas", "bestLambda"):
        assert ps[key] == js[key], key
    assert set(ps["convergence"]) == set(js["convergence"])
    for lam, pc in ps["convergence"].items():
        jc = js["convergence"][lam]
        assert (pc["iterations"], pc["reason"]) == \
            (jc["iterations"], jc["reason"]), lam
        np.testing.assert_allclose(pc["finalObjective"], jc["finalObjective"],
                                   rtol=1e-10, err_msg=lam)
    assert set(ps["validationMetrics"]) == set(js["validationMetrics"])
    for lam, pm in ps["validationMetrics"].items():
        jm = js["validationMetrics"][lam]
        assert set(pm) == set(jm)
        for name in pm:
            np.testing.assert_allclose(pm[name], jm[name], rtol=1e-9,
                                       err_msg=f"{lam} {name}")
    texts = [Path("best-model") / "model.txt"] + [
        Path("all-models") / lam / "model.txt" for lam in ps["convergence"]]
    for rel in texts:
        pk, pv = _text_model(pdir / rel)
        jk, jv = _text_model(jdir / rel)
        assert pk == jk, rel
        np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-8, err_msg=rel)
    pi = json.loads((pdir / "feature-index.json").read_text())
    assert pi == json.loads((jdir / "feature-index.json").read_text())
    imap = IndexMap.load(pdir / "feature-index.json")
    (prec,) = read_container(pdir / "best-model" / "model.avro")
    (jrec,) = read_container(jdir / "best-model" / "model.avro")
    for key in ("modelId", "modelClass", "lossFunction"):
        assert prec[key] == jrec[key]
    for field in ("means", "variances"):
        if jrec[field] is None:
            assert prec[field] is None
            continue
        got, want = ({(r["name"], r["term"]): r["value"] for r in rec[field]}
                     for rec in (prec, jrec))
        assert set(got) == set(want), field
        keys = sorted(got)
        np.testing.assert_allclose([got[k] for k in keys],
                                   [want[k] for k in keys], rtol=0, atol=1e-8,
                                   err_msg=field)
    assert len(imap) == ps["numFeatures"]


def _assert_close_json(a, b, path="$"):
    """Equal structure and strings; numbers within rtol 1e-8."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_close_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close_json(x, y, f"{path}[{i}]")
    elif isinstance(b, bool) or b is None or isinstance(b, str):
        assert a == b, (path, a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-8, err_msg=path)


@pytest.fixture(scope="module")
def example(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("glm_example")
    return _run_both(out, [
        "--training-data-directory", str(data["train"]),
        "--validating-data-directory", str(data["validate"]),
        *EXAMPLE_FLAGS])


def test_example_flags_agree_with_jax(example):
    ps = example["port"][0]
    assert ps["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED",
                            "DIAGNOSED"]
    assert ps["lambdas"] == [100.0, 10.0, 1.0, 0.1]
    _assert_same_run(example)


def test_example_validation_metrics_agree_with_jax(example):
    (_, pdir), (_, jdir) = example["port"], example["jax"]
    pv = json.loads((pdir / "validation-metrics.json").read_text())
    jv = json.loads((jdir / "validation-metrics.json").read_text())
    assert set(pv) == {"metrics", "metricMetadata"}
    assert pv["metricMetadata"] == jv["metricMetadata"]
    assert set(pv["metrics"]) == set(jv["metrics"])
    for lam, pm in pv["metrics"].items():
        assert set(pm) == set(jv["metrics"][lam])
        for name, value in pm.items():
            np.testing.assert_allclose(value, jv["metrics"][lam][name],
                                       rtol=1e-9, err_msg=f"{lam} {name}")


def test_example_diagnostics_agree_with_jax(example):
    (_, pdir), (_, jdir) = example["port"], example["jax"]
    pd = json.loads((pdir / "model-diagnostic.json").read_text())
    jd = json.loads((jdir / "model-diagnostic.json").read_text())
    assert len(pd["models"]) == 4
    for chapter in pd["models"]:
        assert {"featureImportance", "fitting", "bootstrap",
                "hosmerLemeshow", "predictionErrorIndependence"} <= \
            set(chapter)
    _assert_close_json(pd, jd)
    assert (pdir / "model-diagnostic.html").read_text().startswith(
        "<!DOCTYPE html>")


@pytest.mark.parametrize("case", ["tron-linear", "poisson", "owlqn-enet",
                                  "boxes"])
def test_solver_routes_agree_with_jax(data, tmp_path, case):
    box = json.dumps([{"name": "*", "term": "*", "lowerBound": -0.3,
                       "upperBound": 0.3}])
    avro = ["--training-data-directory", str(data["train"]),
            "--validating-data-directory", str(data["validate"]),
            "--task", "LOGISTIC_REGRESSION", "--dtype", "float64"]
    flags = {
        "tron-linear": [
            "--training-data-directory", str(data["linear"]),
            "--task", "LINEAR_REGRESSION", "--format", "LIBSVM",
            "--optimizer", "TRON", "--regularization-weights", "1,0.01",
            "--compute-variance", "true", "--dtype", "float64"],
        "poisson": [
            "--training-data-directory", str(data["poisson"]),
            "--validating-data-directory", str(data["poisson"]),
            "--task", "POISSON_REGRESSION", "--format", "LIBSVM",
            "--regularization-weights", "1,0.1", "--dtype", "float64"],
        "owlqn-enet": [
            *avro, "--regularization-type", "ELASTIC_NET",
            "--elastic-net-alpha", "0.5", "--regularization-weights",
            "10,1", "--normalization-type", "SCALE_WITH_STANDARD_DEVIATION"],
        "boxes": [
            *avro, "--normalization-type", "STANDARDIZATION",
            "--coefficient-box-constraints", box,
            "--regularization-weights", "1,0.1", "--compute-variance",
            "true"],
    }[case]
    runs = _run_both(tmp_path, flags)
    _assert_same_run(runs)
    if case == "boxes":
        _, means = _text_model(runs["port"][1] / "best-model" / "model.txt")
        assert means.size and np.isfinite(means).all()


def test_selected_features_and_summarization_agree_with_jax(data, tmp_path):
    sel = tmp_path / "selected.avro"
    write_container(sel, schemas.NAME_TERM_VALUE,
                    [{"name": f"f{j}", "term": None, "value": 0.0}
                     for j in (0, 2, 5)])
    runs = _run_both(tmp_path, [
        "--training-data-directory", str(data["train"]),
        "--validating-data-directory", str(data["validate"]),
        "--task", "LOGISTIC_REGRESSION", "--regularization-weights", "1",
        "--selected-features-file", str(sel), "--dtype", "float64"])
    _assert_same_run(runs)
    assert runs["port"][0]["numFeatures"] == 4

    summaries = {}
    for side, module, kw in (("port", glm_driver, {"device": "cpu"}),
                             ("jax", jax_glm, {})):
        module.run([
            "--training-data-directory", str(data["train"]),
            "--output-directory", str(tmp_path / f"s-{side}"),
            "--task", "LOGISTIC_REGRESSION", "--regularization-weights", "1",
            "--max-num-iterations", "5", "--dtype", "float64",
            "--summarization-output-dir", str(tmp_path / f"sum-{side}")],
            **kw)
        summaries[side] = list(read_container(
            tmp_path / f"sum-{side}" / "part-00000.avro"))
    assert len(summaries["port"]) == 9
    assert summaries["port"] == summaries["jax"]


def test_offheap_json_store_agrees_with_jax(data, tmp_path):
    """A JSON index store with a feature the data lacks and without two
    that it has: those two are dropped, as the reference's ingest drops
    unknown features."""
    store = tmp_path / "store"
    store.mkdir()
    keys = [f"f{j}" for j in (7, 1, 3, 0, 6)] + ["ghost"]
    IndexMap.from_keys(keys, add_intercept=True).save(store / "global.json")
    runs = _run_both(tmp_path, [
        "--training-data-directory", str(data["train"]),
        "--validating-data-directory", str(data["validate"]),
        "--task", "LOGISTIC_REGRESSION", "--regularization-weights", "10,1",
        "--offheap-indexmap-dir", str(store),
        "--offheap-indexmap-namespace", "global",
        "--normalization-type", "STANDARDIZATION", "--dtype", "float64"])
    _assert_same_run(runs)
    assert runs["port"][0]["numFeatures"] == 7


def test_validate_data_rejects_bad_labels_like_jax(data, tmp_path):
    bad = tmp_path / "bad"
    gen = _generator()
    recs = gen.glm_records(np.random.default_rng(5), 40, np.ones(9))
    recs[3]["label"] = 2.0
    _write(bad, recs)
    flags = ["--training-data-directory", str(bad), "--task",
             "LOGISTIC_REGRESSION", "--dtype", "float64"]
    with pytest.raises(ValueError) as port_err:
        glm_driver.run([*flags, "--output-directory", str(tmp_path / "p")],
                       device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_glm.run([*flags, "--output-directory", str(tmp_path / "j")])
    assert str(port_err.value) == str(jax_err.value)
    assert "binary 0/1 labels" in str(port_err.value)


def test_profile_output_dir_names_its_roadmap_item(data, tmp_path):
    """--profile-output-dir raised naming ROADMAP A5 until the telemetry
    core came (A5b); it now writes a torch.profiler trace of the train
    phase, whose host operations hold the solves."""
    summary = glm_driver.run([
        "--training-data-directory", str(data["train"]),
        "--output-directory", str(tmp_path / "out"),
        "--task", "LOGISTIC_REGRESSION", "--max-num-iterations", "5",
        "--profile-output-dir", str(tmp_path / "prof")], device="cpu")
    assert "TRAINED" in summary["stages"]
    (trace,) = (tmp_path / "prof").glob("torch_trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
