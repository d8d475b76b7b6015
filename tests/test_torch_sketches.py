"""The port's mergeable sketches (photon_ml_tpu_torch/telemetry/sketches.py)
and convergence ring against the JAX package's, on the CPU: the same
numpy payloads, made from a seed, go through both.

- Serialized state, ``digest()`` and ``state()`` of the quantile,
  moments and top-K sketches are equal byte for byte, after single
  updates, after a stream of updates and after every merge tree (left,
  right and balanced); a state made by one package restores in the
  other to the same bytes.
- Quantiles, CDFs, summaries, ``psi`` and ``ks`` are equal exactly.
- Each package's own contract holds in the port: any merge tree gives
  the single stream's bytes, non-finite values are refused, top-K
  guarantees hold.
- The convergence ring keeps the same bounded tail.
"""

import numpy as np
import pytest

from photon_ml_tpu.optimization.convergence import (
    ConvergenceRing as JaxRing,
)
from photon_ml_tpu.telemetry import sketches as jsk
from photon_ml_tpu_torch.optimization.convergence import ConvergenceRing
from photon_ml_tpu_torch.telemetry import sketches as tsk
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

KINDS = ("QuantileSketch", "MomentsSketch")


def _streams(seed=7):
    """Payloads that stress the bucket grid and the exact sums: a heavy
    tail, signed values, a tie block, zeros, a near-zero cluster and 40
    decades, shuffled."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([
        rng.lognormal(0, 3, 4000), -rng.lognormal(1, 2, 3000),
        np.full(1500, 2.5), np.zeros(800), rng.normal(0, 1e-12, 400),
        10.0 ** rng.uniform(-20, 20, 300)])
    rng.shuffle(base)
    return base


def _build(mod, kind, chunk, **kw):
    s = getattr(mod, kind)(**kw)
    s.update(chunk)
    return s


def _trees(mod, kind, chunks):
    """Single stream, left fold, right fold and a balanced tree over the
    same chunks, in one package."""
    single = getattr(mod, kind)()
    for c in chunks:
        single.update(c)
    left = _build(mod, kind, chunks[0])
    for c in chunks[1:]:
        left.merge(_build(mod, kind, c))
    right = _build(mod, kind, chunks[-1])
    for c in chunks[-2::-1]:
        node = _build(mod, kind, c)
        node.merge(right)
        right = node
    parts = [_build(mod, kind, c) for c in chunks]
    t1 = parts[3].merge(parts[5])
    t2 = parts[1].merge(parts[0]).merge(parts[6])
    balanced = t1.merge(t2).merge(parts[2].merge(parts[4]))
    return single, left, right, balanced


@pytest.mark.parametrize("kind", KINDS)
def test_state_bytes_equal_across_packages_and_merge_trees(kind):
    chunks = np.array_split(_streams(), 7)
    mine = _trees(tsk, kind, chunks)
    theirs = _trees(jsk, kind, chunks)
    blobs = {s.serialize() for s in mine + theirs}
    assert len(blobs) == 1
    assert mine[0].digest() == theirs[0].digest()
    assert mine[0].state() == theirs[0].state()
    # A state made by either package restores in the other.
    assert tsk.sketch_from_state(theirs[0].state()).serialize() \
        == theirs[0].serialize()
    assert jsk.sketch_from_state(mine[0].state()).serialize() \
        == mine[0].serialize()


@pytest.mark.parametrize("acc", [0.01, 0.02, 0.05])
def test_quantiles_cdf_and_summaries_equal(acc):
    data = _streams(11)
    mine = _build(tsk, "QuantileSketch", data, relative_accuracy=acc)
    theirs = _build(jsk, "QuantileSketch", data, relative_accuracy=acc)
    assert mine.serialize() == theirs.serialize()
    for q in (0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert mine.quantile(q) == theirs.quantile(q)
    for x in (-1e3, -2.5, 0.0, 1e-12, 2.5, 1e5):
        assert mine.cdf(x) == theirs.cdf(x)
    assert mine.boundaries() == theirs.boundaries()
    assert mine.summary() == theirs.summary()
    m, j = (_build(mod, "MomentsSketch", data) for mod in (tsk, jsk))
    assert m.summary() == j.summary()
    assert (m.mean, m.variance) == (j.mean, j.variance)


def test_float32_payloads_widen_alike():
    """A float32 payload (a card's scores) widens to float64 the same
    way in both packages."""
    v = np.random.default_rng(5).normal(0, 3, 5000).astype(np.float32)
    for kind in KINDS:
        assert _build(tsk, kind, v).serialize() \
            == _build(jsk, kind, v).serialize()


def test_topk_state_and_guarantees_equal():
    rng = np.random.default_rng(4)
    keys = np.concatenate([
        np.full(3000, "hot"), np.full(1200, "warm"),
        rng.integers(0, 400, 5000).astype(str)])
    rng.shuffle(keys)
    batches = np.array_split(keys, 9)
    mine, theirs = tsk.TopKSketch(8), jsk.TopKSketch(8)
    for b in batches:
        codes, counts = np.unique(b, return_counts=True)
        mine.update(codes, counts)
        theirs.update(codes, counts)
    assert mine.serialize() == theirs.serialize()
    assert mine.items() == theirs.items()
    assert mine.error_bound() == theirs.error_bound()
    assert {"hot", "warm"} <= dict(mine.items()).keys()
    # Merge: counters add, the (k+1)-th largest comes off, bounds add.
    a, b = tsk.TopKSketch(8), tsk.TopKSketch(8)
    ja, jb = jsk.TopKSketch(8), jsk.TopKSketch(8)
    for s, js, part in ((a, ja, keys[:6000]), (b, jb, keys[6000:])):
        s.update(part)
        js.update(part)
    assert a.merge(b).serialize() == ja.merge(jb).serialize()


def test_drift_scores_equal():
    rng = np.random.default_rng(2)
    ref_v = rng.normal(0, 1, 20_000)
    cur = {"same": rng.normal(0, 1, 20_000),
           "shifted": rng.normal(2.0, 1, 20_000),
           "scaled": rng.normal(0, 4, 20_000)}
    ref_t = _build(tsk, "QuantileSketch", ref_v, relative_accuracy=0.02)
    ref_j = _build(jsk, "QuantileSketch", ref_v, relative_accuracy=0.02)
    for name, v in cur.items():
        t = _build(tsk, "QuantileSketch", v, relative_accuracy=0.02)
        j = _build(jsk, "QuantileSketch", v, relative_accuracy=0.02)
        for bins in (10, 20):
            assert tsk.psi(ref_t, t, bins=bins) == jsk.psi(ref_j, j,
                                                            bins=bins), name
        assert tsk.ks(ref_t, t) == jsk.ks(ref_j, j), name
        # State-dict operands (the model-artifact form) across packages.
        assert tsk.psi(ref_j.state(), j.state()) == jsk.psi(ref_j, j)
    assert tsk.psi(ref_t, tsk.QuantileSketch(0.02)) is None
    assert tsk.ks(ref_t, ref_t) == 0.0


def test_non_finite_refused_like_jax():
    for kind in KINDS:
        for mod in (tsk, jsk):
            with pytest.raises(ValueError):
                getattr(mod, kind)().update([1.0, float("nan")])


def test_canonical_json_equal():
    obj = {"b": [1, 2.5, None], "a": {"z": "x", "c": 1e-300},
           "λ": float(np.float32(0.1))}
    assert tsk._canonical_json(obj) == jsk._canonical_json(obj)


def test_convergence_ring_bounded_like_jax():
    rings = (ConvergenceRing(capacity=8), JaxRing(capacity=8))
    for ring in rings:
        for i in range(20):
            ring.append(i, 100.0 - i, 1.0 / (i + 1),
                        None if i == 0 else 0.5)
    snaps = [r.snapshot() for r in rings]
    assert snaps[0] == snaps[1]
    assert snaps[0]["recorded"] == 20 and len(snaps[0]["tail"]) == 8
    with pytest.raises(ValueError):
        ConvergenceRing(capacity=0)
