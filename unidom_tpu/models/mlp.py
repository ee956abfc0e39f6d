"""Policy MLP, replacing ``brax.training.networks.make_model``
(reference apg.py:353-358: layer sizes [512, 256, param_size], swish).

Plain JAX. The parameter tree is
``{"params": {"dense_i": {"kernel": (in, out), "bias": (out,)}}}``, the
layout K-FAC (algorithms/kfac.py) and saved checkpoints address.
"""

from typing import Sequence

import jax
import jax.numpy as jnp


def _layer_names(n):
    return [f"dense_{i}" for i in range(n)]


class PolicyMLP:
    """``init(key) -> params`` / ``apply(params, obs) -> logits``: dense
    layers with lecun-normal kernels, zero biases, swish between layers."""

    def __init__(self, layer_sizes: Sequence[int], obs_size: int):
        self.layer_sizes = tuple(layer_sizes)
        self.obs_size = obs_size

    def init(self, key):
        lecun_normal = jax.nn.initializers.lecun_normal()
        keys = jax.random.split(key, len(self.layer_sizes))
        fan_in = (self.obs_size,) + self.layer_sizes[:-1]
        return {"params": {
            name: {
                "kernel": lecun_normal(k, (n_in, n_out), jnp.float32),
                "bias": jnp.zeros((n_out,), jnp.float32),
            }
            for name, k, n_in, n_out in zip(
                _layer_names(len(self.layer_sizes)), keys, fan_in,
                self.layer_sizes)
        }}

    def apply(self, params, x):
        names = _layer_names(len(self.layer_sizes))
        for i, name in enumerate(names):
            layer = params["params"][name]
            x = x @ layer["kernel"] + layer["bias"]
            if i < len(names) - 1:
                x = jax.nn.swish(x)
        return x


def make_policy_model(param_size: int, obs_size: int, hidden=(512, 256)):
    return PolicyMLP(tuple(hidden) + (param_size,), obs_size)
