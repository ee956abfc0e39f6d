"""Dense vs scatter transfer parity, one material per scene: water,
elastic, sigma-clip plastic, von Mises (cases in mpm_transfer_cases.py)."""

import pytest

from mpm_transfer_cases import check_action_grad, check_forward, check_param_grad

SCENES = ['water', 'elastic', 'plastic_clip', 'von_mises']


@pytest.mark.parametrize("scene", SCENES)
def test_forward_parity(scene):
    check_forward(scene)


@pytest.mark.parametrize("scene", SCENES)
def test_action_grad_parity(scene):
    check_action_grad(scene)


@pytest.mark.parametrize("scene", SCENES)
def test_param_grad_parity(scene):
    check_param_grad(scene)
