"""unidom_tpu: a differentiable deformable-object manipulation framework in JAX.

A ground-up JAX/XLA re-design of the capability set of Kuroki1931/UniDOM
(DaXBench differentiable MPM + mass-spring cloth, APG training,
parameter-aware policies, trajectory optimization, PointNet++ parameter
estimation):

- pure-functional simulators over typed state pytrees (zero recompiles for
  parameter randomization),
- `vmap` env batching sized to fill a device, `shard_map` over a device mesh
  for data parallelism with a `pmean` gradient all-reduce,
- `jax.checkpoint`-based rematerialization replacing hand-rolled
  recompute-VJP machinery.

The import name keeps the project's original name; the program runs on
NVIDIA GPUs through XLA.
"""

__version__ = "0.1.0"


def make_env(name, **kwargs):
    """Instantiate a registered environment by name (lazy import to keep the
    base package import light)."""
    from unidom_tpu.envs.registration import env_functions

    return env_functions[name](**kwargs)
