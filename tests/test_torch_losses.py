"""Parity: the port's pointwise losses and their derivatives against
photon_ml_tpu.ops.losses, float64, on a margin grid that reaches +-1e3.
rtol 1e-12 (same formulas; only libm rounding may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.types import TaskType
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

Z = np.concatenate([np.linspace(-40.0, 40.0, 161),
                    [-1e3, -300.0, -1.0, -1e-8, 0.0, 1e-8, 0.5, 1.0, 300.0,
                     1e3]])


@pytest.mark.parametrize("task", list(TaskType))
@pytest.mark.parametrize("fn", ["loss", "d1", "d2"])
def test_losses_match_jax(task, fn):
    if task == TaskType.POISSON_REGRESSION:
        labels = [0.0, 1.0, 3.0]
    else:
        labels = [0.0, 1.0]
    ours = losses.loss_for_task(task)
    ref = jax_losses.loss_for_task(JaxTaskType(task.value))
    assert ours.name == ref.name
    assert ours.twice_differentiable == ref.twice_differentiable
    for label in labels:
        y = np.full_like(Z, label)
        got = getattr(ours, fn)(torch.as_tensor(Z), torch.as_tensor(y))
        want = np.asarray(getattr(ref, fn)(jnp.asarray(Z), jnp.asarray(y)))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_log1p_exp_is_stable():
    z = torch.tensor([-1e3, -50.0, 0.0, 50.0, 1e3], dtype=torch.float64)
    want = np.asarray(jax_losses._log1p_exp(jnp.asarray(z.numpy())))
    np.testing.assert_allclose(losses._log1p_exp(z).numpy(), want,
                               rtol=1e-12)
    assert torch.isfinite(losses._log1p_exp(z)).all()


def test_lookup_by_name():
    for loss in (losses.LogisticLoss, losses.SquaredLoss,
                 losses.PoissonLoss, losses.SmoothedHingeLoss):
        assert losses.loss_by_name(loss.name) is loss
        assert jax_losses.loss_by_name(loss.name).name == loss.name
    assert sorted(x.kernel_id for x in (
        losses.LogisticLoss, losses.SquaredLoss, losses.PoissonLoss,
        losses.SmoothedHingeLoss)) == [0, 1, 2, 3]
