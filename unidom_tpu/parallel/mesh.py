"""Device-mesh construction for env-axis data parallelism.

The reference scales with ``jax.pmap(minimize, axis_name="i")`` over local
GPUs and NCCL all-reduce (apg.py:269-271, 235). Here: a 1-D ``Mesh`` over the
``env`` axis; the training step runs under ``shard_map`` with env-batch
sharded along it, gradients ``pmean``-reduced (an NCCL all-reduce over
NVLink between the GPUs of one host), and parameters replicated. Several
hosts extend the same mesh across processes via
``jax.distributed.initialize``, one process per host owning its local GPUs,
with no code change.
"""

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host bring-up (no-op when single-process). The reference carries
    process_count/index scaffolding but never initializes distributed JAX
    (apg.py:58-79); here it is one call."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_env_mesh(num_devices=None):
    """1-D mesh over the env axis using up to ``num_devices`` devices."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), ("env",))
