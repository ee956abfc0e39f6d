"""Plain-JAX policy MLP: parameter-tree layout, forward pass against an
explicit numpy computation, initialization statistics, and a trainer that
imports without flax."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unidom_tpu.models.mlp import make_policy_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("obs, hidden, out", [(20, (32, 16), 12), (7, (5,), 3)])
def test_param_tree_layout(obs, hidden, out):
    model = make_policy_model(out, obs, hidden=hidden)
    params = model.init(jax.random.PRNGKey(0))
    sizes = (obs,) + hidden + (out,)
    assert set(params) == {"params"}
    assert sorted(params["params"]) == [f"dense_{i}" for i in range(len(sizes) - 1)]
    for i in range(len(sizes) - 1):
        layer = params["params"][f"dense_{i}"]
        assert set(layer) == {"kernel", "bias"}
        assert layer["kernel"].shape == (sizes[i], sizes[i + 1])
        assert layer["bias"].shape == (sizes[i + 1],)
        assert layer["kernel"].dtype == jnp.float32


@pytest.mark.parametrize("hidden", [(32, 16), (8,)])
def test_forward_matches_numpy(hidden):
    model = make_policy_model(4, 6, hidden=hidden)
    params = model.init(jax.random.PRNGKey(1))
    # non-zero biases so their placement is checked too
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.cos(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape),
        params)
    x = np.random.RandomState(0).normal(size=(3, 6)).astype(np.float32)

    h = x.astype(np.float64)
    n = len(hidden) + 1
    for i in range(n):
        layer = params["params"][f"dense_{i}"]
        h = h @ np.asarray(layer["kernel"], np.float64) + np.asarray(layer["bias"], np.float64)
        if i < n - 1:
            h = h / (1.0 + np.exp(-h))  # swish
    np.testing.assert_allclose(np.asarray(model.apply(params, x)), h, rtol=1e-5, atol=1e-6)


def test_init_statistics():
    """lecun-normal kernels (std 1/sqrt(fan_in), truncated at 2 std before
    rescaling) and zero biases."""
    model = make_policy_model(12, 400, hidden=(512, 256))
    params = model.init(jax.random.PRNGKey(2))["params"]
    for name, fan_in in (("dense_0", 400), ("dense_1", 512), ("dense_2", 256)):
        k = np.asarray(params[name]["kernel"])
        std = 1.0 / np.sqrt(fan_in)
        assert abs(k.mean()) < 0.1 * std
        np.testing.assert_allclose(k.std(), std, rtol=0.05)
        # truncation at 2 of the pre-rescaling std (std / 0.8796)
        assert np.abs(k).max() <= 2.0 * std / 0.87962566 * (1 + 1e-5)
        assert not np.any(np.asarray(params[name]["bias"]))
    k0 = np.asarray(params["dense_0"]["kernel"])
    k0b = np.asarray(model.init(jax.random.PRNGKey(3))["params"]["dense_0"]["kernel"])
    assert not np.allclose(k0, k0b)  # the key matters


def test_trainer_imports_without_flax():
    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import unidom_tpu.algorithms.apg, unidom_tpu.envs.registration\n"
        "import unidom_tpu.models\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
