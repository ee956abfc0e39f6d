"""Dense vs scatter transfer parity for colliders, control modes and
mixtures: position control, sphere collider, water+elastic mixture,
container SDF (cases in mpm_transfer_cases.py); grid mass and momentum
conservation of both transfers."""

import numpy as np
import pytest

from mpm_transfer_cases import (
    build,
    check_action_grad,
    check_forward,
    check_param_grad,
)

SCENES = ['position_control', 'collide', 'mixture', 'container']


@pytest.mark.parametrize("scene", SCENES)
def test_forward_parity(scene):
    check_forward(scene)


@pytest.mark.parametrize("scene", SCENES)
def test_action_grad_parity(scene):
    check_action_grad(scene)


@pytest.mark.parametrize("scene", SCENES)
def test_param_grad_parity(scene):
    check_param_grad(scene)


@pytest.mark.parametrize("transfer", ["dense", "scatter"])
def test_p2g_conserves_mass_and_momentum(transfer):
    """Particles well inside the grid deposit all their mass, and the
    affine term adds no net momentum (sum_i w_i (x_i - x_p) = 0)."""
    sim, state = build("mixture", transfer)
    conf = sim.conf
    x, v, C = state.x[0], state.v[0], state.C[0]
    grid_v, grid_m = sim._p2g(x, v, conf.p_mass * C)
    P = sim.n_particles
    np.testing.assert_allclose(float(grid_m.sum()), P * conf.p_mass, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(grid_v.reshape(-1, 3).sum(0)),
        np.asarray(conf.p_mass * v.sum(0)), rtol=1e-4, atol=1e-9)
