"""Parameter-aware APG training (GenDOM/GenORM capability).

Reference: DaXBench/daxbench/algorithms/apg/{apg_para.py, apg_no_para.py}.
Each training iteration randomizes the material stiffness per env in
[train_min_stiff, train_max_stiff]; evaluation sweeps a grid of stiffness
values in [eval_min_stiff, eval_max_stiff]. With ``--env fold_cloth1_para``
the policy observes the normalized stiffness (parameter-conditioned,
apg_para.py); with a plain env it does not (apg_no_para.py) — one trainer
covers both.

Design delta: the reference re-instantiates the env (and with it every
jit trace) for each stiffness draw (apg_para.py:314-420). Here stiffness is
traced ``ClothState`` — randomization is a ``_replace`` on device arrays and
training causes **zero** recompiles across the whole sweep.
"""

import argparse
import json
import os
import pickle
import time
from typing import Optional

import jax
import jax.numpy as jnp

from unidom_tpu.algorithms.apg import build_apg
from unidom_tpu.parallel.mesh import make_env_mesh


def randomize_stiffness(state, key, lo, hi):
    """Per-env stiffness draw, broadcast to the state's stiffness leaf."""
    batch = state.stiffness.shape[0]
    draw = jax.random.uniform(key, (batch,), minval=lo, maxval=hi)
    return state._replace(stiffness=draw.astype(state.stiffness.dtype))


def train_para(
    env_name: str = "fold_cloth1_para",
    episode_length: int = 3,
    num_envs: int = 4,
    learning_rate: float = 1e-4,
    max_it: int = 2000,
    max_gradient_norm: float = 0.3,
    seed: int = 0,
    eval_freq: int = 100,
    num_eval_envs: int = 4,
    train_min_stiff: float = 1000.0,
    train_max_stiff: float = 1600.0,
    eval_min_stiff: float = 10.0,
    eval_max_stiff: float = 1800.0,
    n_eval_points: int = 10,
    num_devices: Optional[int] = None,
    logdir: Optional[str] = None,
):
    from unidom_tpu.envs.registration import env_functions

    mesh = make_env_mesh(num_devices)
    n_devices = mesh.devices.size
    assert num_envs % n_devices == 0

    logdir = logdir or (
        f"logs/apg_para/{env_name}/ep{episode_length}_env{num_envs}"
        f"_stiff{train_min_stiff}-{train_max_stiff}/seed{seed}"
    )
    os.makedirs(logdir, exist_ok=True)
    metrics_file = open(os.path.join(logdir, "metrics.jsonl"), "a")

    kwargs = {}
    if env_name.endswith("_para"):
        kwargs["eval_min_max_stiff"] = (eval_min_stiff, eval_max_stiff)
    env = env_functions[env_name](
        batch_size=num_envs // n_devices, seed=seed, aux_reward=True, **kwargs
    )
    eval_env = env_functions[env_name](batch_size=num_eval_envs, seed=seed + 666, **kwargs)

    init_ts, minimize, reset_batch, _ = build_apg(
        env, episode_length, learning_rate, max_gradient_norm, None, mesh
    )
    _, _, _, run_eval = build_apg(
        eval_env, episode_length, learning_rate, max_gradient_norm, None,
        make_env_mesh(1),
    )

    training_state = init_ts(seed)
    key = jax.random.PRNGKey(seed)
    key_eval = jax.random.PRNGKey(seed + 666)
    _, eval_first_state = eval_env.reset(key_eval)
    sweep = jnp.linspace(eval_min_stiff, eval_max_stiff, n_eval_points)

    t0 = time.time()
    best_mean = -float("inf")
    for it in range(max_it + 1):
        # fixed reset key (reference cloth discipline, apg.py:296-307):
        # only the stiffness draw varies between iterations
        key, k_stiff = jax.random.split(key)
        first_state = reset_batch(jax.random.PRNGKey(seed))
        first_state = randomize_stiffness(
            first_state, k_stiff, train_min_stiff, train_max_stiff
        )

        if it % eval_freq == 0:
            per_stiff = {}
            for s in sweep:
                st = eval_first_state._replace(
                    stiffness=jnp.full_like(eval_first_state.stiffness, s)
                )
                _, _, reward_list = run_eval(
                    training_state.policy_params,
                    training_state.normalizer_params,
                    st,
                    key_eval,
                )
                per_stiff[float(s)] = float(reward_list.sum(0).mean())
            mean_r = sum(per_stiff.values()) / len(per_stiff)
            print(f"[it {it}] eval sweep mean {mean_r:.4f} "
                  + " ".join(f"{k:.0f}:{v:.3f}" for k, v in per_stiff.items()))
            with open(os.path.join(logdir, f"apg_para_{env_name}_{it}.pkl"), "wb") as f:
                pickle.dump(jax.device_get({
                    "policy_params": training_state.policy_params,
                    "sweep": per_stiff, "it": it,
                }), f)
            if mean_r > best_mean:
                best_mean = mean_r
                with open(
                    os.path.join(logdir, f"apg_para_{env_name}_best.pkl"), "wb"
                ) as f:
                    pickle.dump(jax.device_get({
                        "policy_params": training_state.policy_params,
                        "sweep": per_stiff, "it": it, "mean": mean_r,
                    }), f)
            metrics_file.write(json.dumps(
                {"it": it, "eval_sweep": per_stiff, "walltime": time.time() - t0}
            ) + "\n")
            metrics_file.flush()

        training_state, metrics = minimize(training_state, first_state)
        jax.block_until_ready(metrics)
        if it % max(1, eval_freq // 4) == 0:
            print(f"[it {it}] train_reward {float(metrics['reward_sum']):.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f}")

    metrics_file.close()
    return training_state


def main(argv=None):
    p = argparse.ArgumentParser(description="Parameter-aware APG trainer")
    p.add_argument("--env", default="fold_cloth1_para")
    p.add_argument("--ep_len", type=int, default=3)
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_it", type=int, default=2000)
    p.add_argument("--max_grad_norm", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_freq", type=int, default=100)
    p.add_argument("--train_min_stiff", type=float, default=1000.0)
    p.add_argument("--train_max_stiff", type=float, default=1600.0)
    p.add_argument("--eval_min_stiff", type=float, default=10.0)
    p.add_argument("--eval_max_stiff", type=float, default=1800.0)
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--logdir", default=None)
    a = p.parse_args(argv)
    train_para(
        env_name=a.env, episode_length=a.ep_len, num_envs=a.num_envs,
        learning_rate=a.lr, max_it=a.max_it, max_gradient_norm=a.max_grad_norm,
        seed=a.seed, eval_freq=a.eval_freq,
        train_min_stiff=a.train_min_stiff, train_max_stiff=a.train_max_stiff,
        eval_min_stiff=a.eval_min_stiff, eval_max_stiff=a.eval_max_stiff,
        num_devices=a.devices, logdir=a.logdir,
    )


if __name__ == "__main__":
    main()
