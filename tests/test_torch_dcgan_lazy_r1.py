"""Two DCGAN RGBD train steps with lazy R1 (``r1_interval=2``: R1 at weight
``lambda_gp * 2``, then none) against the JAX package's, on the same
weights and the JAX step's own draws; the setting and the tolerances are
those of ``test_torch_dcgan.py``, whose helpers this file shares (a file of
its own, so that each file's JAX compile fits its share of the suite's
clock).
"""

import pytest

from test_torch_dcgan import _check_losses, _check_params, _run, weights  # noqa: F401


@pytest.fixture(scope="module")
def lazy_r1(weights):
    return _run(weights, 2, 2)


def test_lazy_r1_losses_match_jax(lazy_r1):
    """R1 at weight ``lambda_gp * 2`` on the first step, none on the second."""
    state, jstate, metrics, jmetrics = lazy_r1
    _check_losses(metrics, jmetrics)
    assert metrics[0]["dis/loss_gp"] > 0 and metrics[1]["dis/loss_gp"] == jmetrics[1]["dis/loss_gp"] == 0.0
    assert state.iteration == int(jstate.iteration) == 2 and state.opt_gen.count == state.opt_dis.count == 2


def test_lazy_r1_params_match_jax(lazy_r1, weights):
    state, jstate, _, _ = lazy_r1
    _check_params(state, jstate, weights[0])
