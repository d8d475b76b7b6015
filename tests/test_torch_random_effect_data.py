"""Parity: the port's random-effect data layer builds the same buckets as
the JAX package from the same GameDataset inputs — equal bucket keys and
every block array (active and passive) exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import game_data as jax_game_data
from photon_ml_tpu.data import random_effect as jax_re
from photon_ml_tpu.data import sampling as jax_sampling
from photon_ml_tpu_torch.data import game_data, random_effect, sampling
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def _columns(seed=21, n=300, d=10, n_users=23):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d))
    x[rng.random((n, d)) < 0.6] = 0.0  # sparse per-user supports
    x[:, 0] = 1.0
    users = rng.zipf(1.6, n) % n_users
    y = (rng.random(n) < 0.4).astype(np.float64)
    off = rng.normal(0, 0.3, n)
    w = rng.uniform(0.5, 2.0, n)
    return dict(responses=y, feature_shards={"user": sp.csr_matrix(x)},
                ids={"userId": users.astype(str)}, offsets=off, weights=w)


CONFIGS = [
    dict(),
    dict(num_active_data_points=12),
    dict(num_active_data_points=10, num_passive_data_points_lower_bound=3),
    dict(num_features_to_samples_ratio=0.5),
    dict(projector_type="IDENTITY"),
]


@pytest.mark.parametrize("extra", CONFIGS)
def test_blocks_identical_to_jax(extra):
    cols = _columns()
    ds = game_data.GameDataset.build(**cols)
    jds = jax_game_data.GameDataset.build(**cols)
    cfg = random_effect.RandomEffectDataConfiguration("userId", "user",
                                                      **extra)
    jcfg = jax_re.RandomEffectDataConfiguration("userId", "user", **extra)
    ours = random_effect.build_random_effect_dataset(
        ds, cfg, seed=3, intercept_col=0, dtype=torch.float64, device="cpu")
    ref = jax_re.build_random_effect_dataset(jds, jcfg, seed=3,
                                             intercept_col=0,
                                             dtype=jnp.float64)
    ref_keys = [(b.n_pad, b.d_pad, 0 if p is None else p.n_pad)
                for b, p in zip(ref.blocks, ref.passive_blocks)]
    assert ours.bucket_keys == ref_keys
    assert len(ours.blocks) > 1
    np.testing.assert_array_equal(ours.vocabulary, ref.vocabulary)
    assert (ours.n_rows, ours.num_global_features) == (
        ref.n_rows, ref.num_global_features)
    pairs = list(zip(ours.blocks, ref.blocks)) + [
        (p, q) for p, q in zip(ours.passive_blocks, ref.passive_blocks)
        if q is not None]
    for codes, jcodes in zip(ours.entity_codes, ref.entity_codes):
        np.testing.assert_array_equal(codes, np.asarray(jcodes))
    for blk, jblk in pairs:
        for field in ("x", "labels", "offsets", "weights", "row_ids",
                      "feat_idx"):
            got, want = getattr(blk, field), np.asarray(getattr(jblk, field))
            assert got.numpy().dtype == want.dtype, field
            np.testing.assert_array_equal(got.numpy(), want, err_msg=field)


def test_config_parse_matches_jax():
    s = "userId,user,8,12,3,0.5,IDENTITY"
    ours = random_effect.RandomEffectDataConfiguration.parse(s)
    ref = jax_re.RandomEffectDataConfiguration.parse(s)
    assert ours.__dict__ == ref.__dict__


def test_reservoir_sample_matches_jax_for_the_same_seed():
    for n, cap in [(5, 8), (50, 12), (1000, 999)]:
        got = sampling.reservoir_sample(np.random.default_rng(9), n, cap)
        want = jax_sampling.reservoir_sample(np.random.default_rng(9), n, cap)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("classification", [True, False])
def test_down_sample_weights_rate(classification):
    """torch.Generator cannot reproduce jax.random's bits, so only the
    sampler's rate and reweighting are checked."""
    n, rate = 40_000, 0.3
    labels = torch.as_tensor((np.arange(n) % 4 == 0).astype(np.float64))
    weights = torch.full((n,), 2.0, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    assert sampling.down_sample_weights(gen, labels, weights, 1.0,
                                        classification) is weights
    out = sampling.down_sample_weights(gen, labels, weights, rate,
                                       classification)
    sampled = labels < 0.5 if classification else torch.ones(n, dtype=bool)
    kept = out[sampled] > 0
    assert abs(float(kept.double().mean()) - rate) < 0.01
    np.testing.assert_allclose(out[sampled][kept].numpy(), 2.0 / rate)
    np.testing.assert_array_equal(out[~sampled].numpy(), 2.0)


def test_random_projector_not_ported():
    """RANDOM=<k> builds latent-space blocks with the projection attached
    (tests/test_torch_projectors.py holds them against the JAX package's);
    an unknown projector raises."""
    ds = game_data.GameDataset.build(**_columns(n=40))
    cfg = random_effect.RandomEffectDataConfiguration(
        "userId", "user", projector_type="RANDOM=4")
    out = random_effect.build_random_effect_dataset(ds, cfg, intercept_col=0,
                                                    device="cpu")
    assert out.projection is not None
    assert out.projection.matrix.shape == (5, 10)
    assert all(b.d_pad == 8 for b in out.blocks)
    bad = random_effect.RandomEffectDataConfiguration(
        "userId", "user", projector_type="GAUSSIAN")
    with pytest.raises(ValueError, match="unknown projector"):
        random_effect.build_random_effect_dataset(ds, bad, device="cpu")
