"""Analytic-policy-gradient (APG) trainer: BPTT through the differentiable
simulator, data-parallel over a device mesh.

Reference: DaXBench/daxbench/algorithms/apg/apg.py:29-443. Semantics kept
operator-for-operator where they affect convergence:
- policy = MLP [512, 256, 2*act] with swish + NormalTanh sampling
  (+ sigmoid squash for cloth-style envs),
- loss = -mean(reward) over a ``lax.scan`` rollout of ``episode_length``
  macro steps (apg.py:206-215), optional stop-gradient truncation windows,
- grad -> nan_to_num -> clip_by_global_norm -> pmean -> adam
  (exactly that order, apg.py:233-240).

Design deltas from the reference:
- ``shard_map`` over a ``Mesh(('env',))`` replaces ``jax.pmap``; the env
  batch is sharded along ``env`` and the gradient ``pmean`` is one
  all-reduce over the devices.
- The LR schedule is a real optax linear schedule. (The reference re-creates
  the optimizer each iteration *after* the pmap trace is built, so its decay
  never reaches the compiled update — apg.py:309-311 is dead code; we
  implement the evident intent, off by default for strict parity.)
- Checkpointing saves params+opt state and supports resume (the reference is
  pickle-save-only, apg.py:325-330).
"""

import argparse
import functools
import json
import os
import pickle
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from unidom_tpu.models.distribution import NormalTanhDistribution
from unidom_tpu.models.mlp import make_policy_model
from unidom_tpu.models.normalizer import (
    create_observation_normalizer,
    normalize,
    update_normalizer,
)
from unidom_tpu.ops.gradops import global_norm_clip
from unidom_tpu.parallel.mesh import make_env_mesh


class TrainingState(NamedTuple):
    key: jnp.ndarray
    normalizer_params: NamedTuple
    optimizer_state: optax.OptState
    policy_params: dict


def _tile_over_devices(tree, n):
    return jax.tree_util.tree_map(lambda x: jnp.concatenate([x] * n, axis=0), tree)


def build_apg(
    env,
    episode_length: int,
    learning_rate: float = 1e-4,
    max_gradient_norm: float = 0.3,
    truncation_length: Optional[int] = None,
    mesh=None,
    lr_decay_iters: Optional[int] = None,
    normalize_obs: bool = False,
    pre_squash_penalty: float = 0.0,
):
    """Build (training_state, minimize, reset_batch, run_eval) for ``env``.

    ``env`` must be constructed with the per-device batch size; ``minimize``
    takes a globally-batched (sharded) first state.
    """
    mesh = mesh or make_env_mesh()
    n_devices = mesh.devices.size

    dist = NormalTanhDistribution(event_size=env.action_size)
    policy_model = make_policy_model(dist.param_size, env.observation_size)

    if lr_decay_iters:
        schedule = optax.linear_schedule(
            init_value=learning_rate, end_value=1e-5, transition_steps=lr_decay_iters
        )
        optimizer = optax.adam(learning_rate=schedule)
    else:
        optimizer = optax.adam(learning_rate=learning_rate)

    def do_one_step(carry, step_index):
        state, params, normalizer_params, key = carry
        key, key_sample = jax.random.split(key)
        obs = env.get_obs(state)
        if normalize_obs:
            obs = normalize(normalizer_params, obs)
        logits = policy_model.apply(params, obs)
        actions = dist.sample(logits, key_sample)
        if env.action_squash == "sigmoid":
            actions = jax.nn.sigmoid(actions)
        obs, reward, done, info = env.step_diff(actions, state)
        nstate = info["state"]
        if truncation_length is not None and truncation_length > 0:
            nstate = jax.lax.cond(
                jnp.mod(step_index + 1, truncation_length) == 0.0,
                jax.lax.stop_gradient,
                lambda x: x,
                nstate,
            )
        loc = logits[..., : env.action_size]
        return (nstate, params, normalizer_params, key), (
            nstate, actions, reward, jnp.mean(loc**2),
        )

    def loss(params, normalizer_params, state, key):
        _, (state_list, action_list, reward_list, loc_sq) = jax.lax.scan(
            do_one_step,
            (state, params, normalizer_params, key),
            jnp.arange(episode_length),
            length=episode_length,
        )
        total = -jnp.mean(reward_list)
        if pre_squash_penalty:
            # Keeps the pre-squash means from blowing past the sigmoid's
            # reachable box — the diagnosed fold_cloth3 saturation
            # attractor (docs/PARITY.md: the means grow until every
            # action pins at a corner of the box). Off by default.
            total = total + pre_squash_penalty * jnp.mean(loc_sq)
        return total, (reward_list, state_list, action_list)

    loss_grad = jax.grad(loss, has_aux=True)

    def _minimize_local(training_state: TrainingState, state):
        key, key_grad = jax.random.split(training_state.key)
        grad_raw, (reward_list, state_list, action_list) = loss_grad(
            training_state.policy_params,
            training_state.normalizer_params,
            state,
            key_grad,
        )
        grad_raw = jax.tree_util.tree_map(jnp.nan_to_num, grad_raw)
        grad = global_norm_clip(grad_raw, max_gradient_norm)
        grad = jax.lax.pmean(grad, axis_name="env")

        normalizer_params = training_state.normalizer_params
        if normalize_obs:
            # moments from this iteration's rollout states; psum over the env
            # axis keeps every replica's statistics identical (brax contract).
            # The reset-state obs is what the policy consumes at t=0, so fold
            # it in alongside the post-step states.
            rollout_obs = jax.vmap(env.get_obs)(state_list)
            obs0 = env.get_obs(state)[None]
            normalizer_params = update_normalizer(
                normalizer_params,
                jnp.concatenate([obs0, rollout_obs], axis=0),
                axis_name="env",
            )

        params_update, optimizer_state = optimizer.update(
            grad, training_state.optimizer_state
        )
        policy_params = optax.apply_updates(training_state.policy_params, params_update)

        metrics = {
            "grad_norm": optax.global_norm(grad_raw),
            "params_norm": optax.global_norm(policy_params),
            "reward": jax.lax.pmean(reward_list.mean(), axis_name="env"),
            "reward_sum": jax.lax.pmean(reward_list.sum(0).mean(), axis_name="env"),
        }
        new_ts = TrainingState(
            key=key,
            normalizer_params=normalizer_params,
            optimizer_state=optimizer_state,
            policy_params=policy_params,
        )
        return new_ts, metrics

    minimize_jit = jax.jit(
        shard_map(
            _minimize_local,
            mesh=mesh,
            in_specs=(P(), P("env")),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )

    def minimize(training_state, state):
        return minimize_jit(training_state, state)

    # testing hook: the pieces needed to recompute the sharded update
    # serially on one device (tests/test_sharding.py invariance check)
    minimize.debug = {
        "loss_grad": loss_grad,
        "optimizer": optimizer,
        "max_gradient_norm": max_gradient_norm,
    }

    # ---------------- reset over the global batch ---------------- #

    def reset_batch(key_env, iteration_key=None):
        """Build a globally-batched, mesh-sharded first state."""
        key = iteration_key if iteration_key is not None else key_env
        if env.reset_mode == "reset":
            keys = jax.random.split(key, n_devices)
            _, states = jax.vmap(env.reset)(keys)
            state = jax.tree_util.tree_map(
                lambda x: x.reshape((-1,) + x.shape[2:]), states
            )
        elif env.reset_mode == "auto_reset":
            first = _tile_over_devices(env.init_state, n_devices)
            keys = jax.random.split(key, env.batch_size * n_devices)
            state = env.auto_reset(first, first, keys)
        else:  # host_reset
            _, local = env.reset(key)
            state = _tile_over_devices(local, n_devices)
        sharding = NamedSharding(mesh, P("env"))
        return jax.device_put(
            state, jax.tree_util.tree_map(lambda _: sharding, state)
        )

    # ---------------- eval ---------------- #

    def _make_eval_step(deterministic):
        def do_one_step_eval(carry, _):
            state, params, normalizer_params, key = carry
            key, key_sample = jax.random.split(key)
            obs = env.get_obs(state)
            if normalize_obs:
                obs = normalize(normalizer_params, obs)
            logits = policy_model.apply(params, obs)
            if deterministic:
                actions = dist.mode(logits)
            else:
                actions = dist.sample(logits, key_sample)
            if env.action_squash == "sigmoid":
                actions = jax.nn.sigmoid(actions)
            obs, reward, done, info = env.step_diff(actions, state)
            return (info["state"], params, normalizer_params, key), (actions, reward)

        return do_one_step_eval

    @functools.partial(jax.jit, static_argnames=("deterministic",))
    def run_eval(params, normalizer_params, state, key, deterministic=False):
        """Eval rollout. ``deterministic=False`` samples actions — the
        reference's eval mode (apg.py:230-237); True uses the distribution
        mode (tanh(loc)), the round-3 saturation-diagnosis probe."""
        (state, _, _, key), (action_list, reward_list) = jax.lax.scan(
            _make_eval_step(deterministic),
            (state, params, normalizer_params, key),
            (),
            length=env.max_steps,
        )
        return state, action_list, reward_list

    # ---------------- initial training state ---------------- #

    def init_training_state(seed):
        key = jax.random.PRNGKey(seed)
        key, key_models = jax.random.split(key)
        policy_params = policy_model.init(key_models)
        ts = TrainingState(
            key=key,
            normalizer_params=create_observation_normalizer(env.observation_size),
            optimizer_state=optimizer.init(policy_params),
            policy_params=policy_params,
        )
        # Pre-place with minimize's replicated output sharding: otherwise
        # the first minimize's outputs (shard_map shardings) re-specialize
        # the jit and the SECOND call pays another ~full XLA compile
        # (~100 s at pour_soup scale — runs/r5/pour_soup_steady_state.log,
        # CLAUDE.md round-5 lessons; reproduced + fixed on the CPU mesh).
        repl = NamedSharding(mesh, P())
        return jax.device_put(
            ts, jax.tree_util.tree_map(lambda _: repl, ts)
        )

    return init_training_state, minimize, reset_batch, run_eval


def _write_eval_gif(env, first_state, action_list, path, fps=10):
    """Replay an eval action sequence through ``step_with_render`` and save
    the frames (the reference's eval GIF path, apg.py:318-330 + imageio).
    """
    import imageio

    state = first_state
    frames = []
    for t in range(action_list.shape[0]):
        _, _, _, info = env.step_with_render(action_list[t], state)
        frames.extend(info["img_list"])
        state = info["state"]
    imageio.mimsave(path, frames, fps=fps)
    return path


# ---------------------------------------------------------------------- #
# CLI trainer
# ---------------------------------------------------------------------- #


def train(
    env_name: str,
    episode_length: int,
    num_envs: int,
    learning_rate: float = 1e-4,
    max_it: int = 2000,
    max_gradient_norm: float = 0.3,
    seed: int = 0,
    eval_freq: int = 20,
    num_eval_envs: int = 20,
    num_devices: Optional[int] = None,
    truncation_length: Optional[int] = None,
    logdir: Optional[str] = None,
    resume: Optional[str] = None,
    save_gif: bool = False,
    lr_decay: bool = False,
    normalize_obs: bool = False,
    randomize_reset: bool = False,
    pre_squash_penalty: float = 0.0,
    aux_reward: bool = True,
    env_kwargs: Optional[dict] = None,
):
    from unidom_tpu.envs.registration import env_functions
    from unidom_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    mesh = make_env_mesh(num_devices)
    n_devices = mesh.devices.size
    assert num_envs % n_devices == 0, (num_envs, n_devices)

    logdir = logdir or (
        f"logs/apg/{env_name}/ep{episode_length}_env{num_envs}_lr{learning_rate}"
        f"_it{max_it}_clip{max_gradient_norm}/seed{seed}"
    )
    # multi-host: artifacts (metrics/ckpt/gif/tensorboard) from process 0 only
    is_lead = jax.process_index() == 0
    os.makedirs(logdir, exist_ok=True)
    metrics_file = open(os.path.join(logdir, "metrics.jsonl"), "a") if is_lead else None
    tb = None
    if is_lead:
        try:  # optional TensorBoard scalars (the reference's SummaryWriter path)
            from tensorboardX import SummaryWriter

            tb = SummaryWriter(logdir)
        except Exception:
            tb = None

    env_kwargs = env_kwargs or {}
    env = env_functions[env_name](
        batch_size=num_envs // n_devices, seed=seed, aux_reward=aux_reward,
        **env_kwargs
    )
    eval_env = env_functions[env_name](
        batch_size=num_eval_envs, seed=seed + 666, **env_kwargs
    )

    key_env = jax.random.split(jax.random.PRNGKey(seed), 2)[0]
    key_eval = jax.random.PRNGKey(seed + 666)
    # MPM/host-reset envs size their observation space at first reset; this
    # must happen BEFORE build_apg reads env.observation_size for the policy
    if env.reset_mode in ("auto_reset", "host_reset"):
        env.reset(key_env)
    _, eval_first_state = eval_env.reset(key_eval)

    init_ts, minimize, reset_batch, _ = build_apg(
        env,
        episode_length,
        learning_rate,
        max_gradient_norm,
        truncation_length,
        mesh,
        lr_decay_iters=max_it if lr_decay else None,
        normalize_obs=normalize_obs,
        pre_squash_penalty=pre_squash_penalty,
    )
    _, _, eval_reset, run_eval = build_apg(
        eval_env,
        episode_length,
        learning_rate,
        max_gradient_norm,
        None,
        make_env_mesh(1),
        normalize_obs=normalize_obs,
    )

    training_state = init_ts(seed)
    if resume:
        with open(resume, "rb") as f:
            saved = pickle.load(f)
        training_state = training_state._replace(
            policy_params=saved["policy_params"],
            optimizer_state=saved.get("optimizer_state", training_state.optimizer_state),
            normalizer_params=saved.get(
                "normalizer_params", training_state.normalizer_params
            ),
        )
        print(f"resumed from {resume}")

    # Reset-key discipline (reference parity, apg.py:298-307): for plain-reset
    # (cloth) envs the reference never re-splits key_env, so every training
    # iteration starts from the SAME initial state; only auto_reset (MPM) envs
    # draw fresh keys each iteration. Round-2's fresh-key-per-iteration cloth
    # resets made each gradient step chase a differently-shifted task while
    # eval sat at a fixed shift — a train/eval divergence the reference never
    # has. --randomize_reset opts back into the harder randomized curriculum.
    fixed_reset_key = env.reset_mode == "reset" and not randomize_reset

    history = []
    best_eval = -float("inf")
    t_total = time.time()
    for it in range(max_it + 1):
        if fixed_reset_key:
            first_state = reset_batch(key_env)
        else:
            key_env, key_iter = jax.random.split(key_env)
            first_state = reset_batch(key_env, key_iter)

        if it % eval_freq == 0:
            _, action_list, reward_list = run_eval(
                training_state.policy_params,
                training_state.normalizer_params,
                eval_first_state,
                key_eval,
            )
            test_reward = float(reward_list.sum(0).mean())
            _, _, det_rewards = run_eval(
                training_state.policy_params,
                training_state.normalizer_params,
                eval_first_state,
                key_eval,
                deterministic=True,
            )
            test_reward_det = float(det_rewards.sum(0).mean())
            if is_lead:
                ckpt = {
                    "policy_params": training_state.policy_params,
                    "optimizer_state": training_state.optimizer_state,
                    "normalizer_params": training_state.normalizer_params,
                    "it": it,
                }
                with open(os.path.join(logdir, f"apg_{env_name}_{it}.pkl"), "wb") as f:
                    pickle.dump(jax.device_get(ckpt), f)
                if test_reward > best_eval:
                    # BPTT through thousands of chaotic substeps can walk the
                    # policy off a good optimum late in training (round-3
                    # diagnosis: saturation attractor); keep the best-eval
                    # params the way the reference keeps per-eval pickles
                    best_eval = test_reward
                    ckpt["test_reward"] = test_reward
                    with open(
                        os.path.join(logdir, f"apg_{env_name}_best.pkl"), "wb"
                    ) as f:
                        pickle.dump(jax.device_get(ckpt), f)
                print(
                    f"[it {it}] test_reward {test_reward:.4f} "
                    f"det {test_reward_det:.4f} (best {best_eval:.4f})"
                )
                if tb is not None:
                    tb.add_scalar("test_reward", test_reward, it)
                    tb.add_scalar("test_reward_det", test_reward_det, it)
                if save_gif:
                    _write_eval_gif(
                        eval_env, eval_first_state, action_list,
                        os.path.join(logdir, f"eval_{it}.gif"),
                    )

        t = time.time()
        training_state, metrics = minimize(training_state, first_state)
        jax.block_until_ready(metrics)
        dt = time.time() - t
        sps = episode_length * num_envs / dt

        rec = {
            "it": it,
            "train_reward": float(metrics["reward_sum"]),
            "grad_norm": float(metrics["grad_norm"]),
            "sps": sps,
            "walltime": time.time() - t_total,
        }
        history.append(rec)
        if metrics_file is not None:
            metrics_file.write(json.dumps(rec) + "\n")
            metrics_file.flush()
        if tb is not None:
            tb.add_scalar("train_reward", rec["train_reward"], it)
            tb.add_scalar("grad_norm", rec["grad_norm"], it)
            tb.add_scalar("sps", sps, it)
        if is_lead and it % max(1, eval_freq // 4) == 0:
            print(
                f"[it {it}] train_reward {rec['train_reward']:.4f} "
                f"grad_norm {rec['grad_norm']:.3f} sps {sps:.1f}"
            )

    if metrics_file is not None:
        metrics_file.close()
    return training_state, history


def main(argv=None):
    parser = argparse.ArgumentParser(description="APG trainer (unidom_tpu)")
    parser.add_argument("--env", default="fold_cloth1")
    parser.add_argument("--ep_len", type=int, default=10)
    parser.add_argument("--num_envs", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--max_it", type=int, default=2000)
    parser.add_argument("--max_grad_norm", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--devices", type=int, default=None,
                        help="number of devices for the env mesh (default: all)")
    parser.add_argument("--eval_freq", type=int, default=20)
    parser.add_argument("--num_eval_envs", type=int, default=20)
    parser.add_argument("--truncation_length", type=int, default=None)
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--lr_decay", action="store_true")
    parser.add_argument("--normalize_obs", action="store_true",
                        help="running-moment observation normalization "
                             "(off by default: reference parity, its brax "
                             "normalizer apply is commented out, apg.py:182)")
    parser.add_argument("--save_gif", action="store_true",
                        help="write an eval rollout GIF to the logdir at every eval")
    parser.add_argument("--no_aux_reward", action="store_true",
                        help="train WITHOUT the contact-distance aux reward "
                             "(the reference trains with it, apg.py:85)")
    parser.add_argument("--pre_squash_penalty", type=float, default=0.0,
                        help="L2 penalty on the policy's pre-squash means "
                             "(anti-saturation; round-3 diagnosis)")
    parser.add_argument("--randomize_reset", action="store_true",
                        help="draw a fresh reset key every iteration for "
                             "plain-reset (cloth) envs; the reference keeps "
                             "the reset key fixed (apg.py:298-307)")
    # multi-host bring-up (docs/MULTIHOST.md); all three omitted in
    # single-process runs
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)

    if args.num_processes is not None:
        from unidom_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes, args.process_id)

    train(
        env_name=args.env,
        episode_length=args.ep_len,
        num_envs=args.num_envs,
        learning_rate=args.lr,
        max_it=args.max_it,
        max_gradient_norm=args.max_grad_norm,
        seed=args.seed,
        eval_freq=args.eval_freq,
        num_eval_envs=args.num_eval_envs,
        num_devices=args.devices,
        truncation_length=args.truncation_length,
        logdir=args.logdir,
        resume=args.resume,
        save_gif=args.save_gif,
        lr_decay=args.lr_decay,
        normalize_obs=args.normalize_obs,
        randomize_reset=args.randomize_reset,
        pre_squash_penalty=args.pre_squash_penalty,
        aux_reward=not args.no_aux_reward,
    )


if __name__ == "__main__":
    main()
