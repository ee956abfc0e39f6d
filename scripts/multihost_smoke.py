"""Two-process multi-host training-step smoke.

Exercises the real multi-host path the reference only scaffolds
(apg.py:58-79 reads process_count/index but never initializes distributed
JAX): ``jax.distributed.initialize`` -> one global ``Mesh('env')`` spanning
both processes -> ``shard_map`` minimize with the gradient ``pmean`` riding
the cross-process collective -> parameters verified bit-identical on every
host.

Run (one line per host / local test):
    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
      python scripts/multihost_smoke.py --num_processes 2 --process_id 0 &
    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
      python scripts/multihost_smoke.py --num_processes 2 --process_id 1

On GPU hosts, drop the env vars and run one process per host, each owning
its local cards, with --coordinator <host0>:8476 (see docs/MULTIHOST.md).
"""

import argparse
import hashlib
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:8476")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    args = ap.parse_args()

    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from unidom_tpu.parallel.mesh import initialize_distributed

    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.experimental import multihost_utils

    assert jax.process_count() == args.num_processes, jax.process_count()
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == n_local * args.num_processes, (n_local, n_global)
    print(f"[p{args.process_id}] {n_local} local / {n_global} global devices",
          file=sys.stderr)

    from unidom_tpu.algorithms.apg import build_apg
    from unidom_tpu.engine.cloth import ClothConf
    from unidom_tpu.envs.cloth_tasks import FoldCloth1Env

    conf = ClothConf(N=20, mem_saving_level=1, n_substeps=5,
                     gripper_radius=0.08, task="mh", goal_path="")
    env = FoldCloth1Env(batch_size=1, conf=conf)  # 1 env per device

    mesh = Mesh(np.array(jax.devices()), ("env",))
    init_ts, minimize, reset_batch, _ = build_apg(env, episode_length=1, mesh=mesh)

    ts = init_ts(0)
    state = reset_batch(jax.random.PRNGKey(0))
    for _ in range(2):
        ts, metrics = minimize(ts, state)
    jax.block_until_ready(metrics)

    reward = float(metrics["reward"])
    assert np.isfinite(reward), reward

    # params must be bit-identical across hosts after the pmean'd update:
    # hash this process's local replica; the launcher compares digests.
    local = np.concatenate([
        np.asarray(l.addressable_data(0)).ravel()
        for l in jax.tree_util.tree_leaves(ts.policy_params)
    ])
    multihost_utils.sync_global_devices("params_read")
    digest = hashlib.sha256(local.tobytes()).hexdigest()[:16]
    print(f"MULTIHOST_OK p{args.process_id} reward={reward:.6f} params={digest}",
          flush=True)


if __name__ == "__main__":
    main()
