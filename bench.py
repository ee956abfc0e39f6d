"""Benchmark: env rollout steps/s/chip (forward + backward).

Prints ONE JSON line on stdout. The primary metric is the flagship
fold_cloth3 APG training iteration at 4096 envs (BASELINE.json's metric:
"env rollout steps/s/chip (fwd+bwd) at 4096 envs"); additional rows —
fold_cloth3 @1024 (round-1/2 comparable) and the whip_rope MPM config —
ride in the same JSON object under "rows". All progress goes to stderr so
stdout stays machine-parseable.

The reference publishes no numbers (BASELINE.md); its throughput probe is
``sps = ep_len * num_envs / iteration_walltime`` from the APG loop
(reference apg.py:340). We report the same quantity for a full BPTT training
iteration (rollout + backward + update), measured on one chip.

``vs_baseline`` is null: no reference-layout rate has been measured on the
GPU yet (scripts/bench_baseline.py measures the cloth one).

Knobs: BENCH_ROWS (comma list from {cloth4096, cloth1024, mpm1024};
default all three), BENCH_NUM_ENVS (override env count for a single cloth
row), BENCH_EP_LEN (3), BENCH_ITERS (3), BENCH_REPS (3),
BENCH_FAST=1 (one 256-env cloth row).

Runs on a GPU only: on any other platform it exits non-zero before measuring,
and a row that fails makes the whole run exit non-zero.
"""

import json
import os
import sys
import time


def log(msg):
    print(f"[bench +{time.time() - T0:.1f}s] {msg}", file=sys.stderr, flush=True)


T0 = time.time()


def _measure_minimize(env, mesh, num_envs, ep_len, iters, reps):
    """Median per-iteration walltime of the full sharded APG update."""
    import jax

    from unidom_tpu.algorithms.apg import build_apg

    init_ts, minimize, reset_batch, _ = build_apg(
        env, episode_length=ep_len, learning_rate=1e-4,
        max_gradient_norm=0.3, mesh=mesh,
    )
    ts = init_ts(0)
    state = reset_batch(jax.random.PRNGKey(0))
    jax.block_until_ready(state)

    # Two warm-up calls: the first call's outputs come back with the
    # shard_map output shardings, which re-specializes the jit once.
    log("compiling minimize")
    for _ in range(2):
        ts, metrics = minimize(ts, state)
        float(metrics["reward"])
    log(f"compile + two warm-up iters done ({time.time() - T0:.1f}s total)")

    # Median over repeated chains: iterations inside a chain stay
    # data-dependent (ts feeds back); the median across chains rejects
    # outliers.
    chain_times = []
    for _ in range(reps):
        t0 = time.time()
        for _ in range(iters):
            ts, metrics = minimize(ts, state)
        float(metrics["reward"])
        chain_times.append((time.time() - t0) / iters)
    dt = sorted(chain_times)[len(chain_times) // 2]
    log(
        f"{reps} chains x {iters} iters done, median {dt:.3f}s/iter "
        f"({[round(t, 2) for t in chain_times]})"
    )
    return dt


def _cloth_row(num_envs, mesh, ep_len, iters, reps):
    from unidom_tpu.engine.cloth import ClothConf
    from unidom_tpu.envs.cloth_tasks import FoldCloth3Env

    n_dev = mesh.devices.size
    num_envs = max(num_envs // n_dev, 1) * n_dev
    log(f"--- cloth row: fold_cloth3 @ {num_envs} envs")
    # mem_saving_level=2 (the reference's fold_cloth3 default): remat both the
    # substep scan and the robot step — residual memory goes from
    # O(substeps * subactions) to O(subactions) states per env.
    conf = ClothConf(
        N=80, stiffness=900.0, mem_saving_level=2, task="bench_fold_cloth3",
        goal_path="", use_substep_obs=False,
    )
    env = FoldCloth3Env(batch_size=num_envs // n_dev, conf=conf)
    dt = _measure_minimize(env, mesh, num_envs, ep_len, iters, reps)
    sps = ep_len * num_envs / dt / n_dev
    return {
        "metric": "fold_cloth3 APG env-steps/s/chip (fwd+bwd)",
        "value": round(sps, 2),
        "unit": "steps/s/chip",
        "vs_baseline": None,
        "num_envs": num_envs,
        "ep_len": ep_len,
        "iter_walltime_s": round(dt, 3),
    }


def _mpm_row(num_envs, mesh, ep_len, iters, reps):
    import jax

    from unidom_tpu.envs.registration import env_functions

    n_dev = mesh.devices.size
    num_envs = max(num_envs // n_dev, 1) * n_dev
    log(f"--- mpm row: whip_rope @ {num_envs} envs")
    # whip_rope: the BASELINE MPM config (70 substeps/macro-step, n_grid 64)
    env = env_functions["whip_rope"](batch_size=num_envs // n_dev, seed=0)
    env.reset(jax.random.PRNGKey(0))  # sizes the observation space
    dt = _measure_minimize(env, mesh, num_envs, ep_len, iters, reps)
    sps = ep_len * num_envs / dt / n_dev
    return {
        "metric": "whip_rope APG env-steps/s/chip (fwd+bwd)",
        "value": round(sps, 2),
        "unit": "steps/s/chip",
        "vs_baseline": None,
        "num_envs": num_envs,
        "ep_len": ep_len,
        "iter_walltime_s": round(dt, 3),
    }


def main():
    from unidom_tpu.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    log(f"compilation cache at {cache_dir}")

    import jax

    from unidom_tpu.parallel.mesh import make_env_mesh

    ep_len = int(os.environ.get("BENCH_EP_LEN", 3))
    iters = int(os.environ.get("BENCH_ITERS", 3))
    reps = int(os.environ.get("BENCH_REPS", 3))

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {platform!r}")
    mesh = make_env_mesh()
    n_dev = mesh.devices.size
    log(f"devices={n_dev} platform={platform} "
        f"kind={jax.devices()[0].device_kind}")

    if os.environ.get("BENCH_FAST"):
        rows_req = ["cloth256"]
    elif os.environ.get("BENCH_NUM_ENVS"):
        rows_req = [f"cloth{int(os.environ['BENCH_NUM_ENVS'])}"]
    else:
        rows_req = os.environ.get(
            "BENCH_ROWS", "cloth4096,cloth1024,mpm1024"
        ).split(",")

    rows = []
    for r in rows_req:
        r = r.strip()
        if r.startswith("cloth"):
            rows.append(_cloth_row(int(r[5:]), mesh, ep_len, iters, reps))
        elif r.startswith("mpm"):
            rows.append(_mpm_row(int(r[3:]), mesh, ep_len, iters, reps))
        else:
            raise SystemExit(f"unknown bench row {r!r}")

    head = dict(rows[0])
    head["rows"] = rows
    head["devices"] = n_dev
    head["platform"] = platform
    head["device_kind"] = jax.devices()[0].device_kind
    head["total_walltime_s"] = round(time.time() - T0, 1)
    print(json.dumps(head), flush=True)


if __name__ == "__main__":
    main()
