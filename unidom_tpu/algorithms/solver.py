"""Gradient-based trajectory optimization through the differentiable
simulator (batched shooting-MPC), plus the expert-data factory.

Reference: the Taichi solver stack
(GenORM/policy/pbm/plb/optimizer/solver.py:24-418 — ``Solver.solve``
optimizes an open-loop action sequence with hand-rolled Adam on ``ti.Tape``
gradients; ``solve_action`` is the expert factory across randomized
(E, nu, yield_stress); optim.py:5-80 implements Adam/Momentum with bounds)
and ``solver_nn.py`` (optimize a policy net through the sim).

Design: the action sequence is a (B, T, A) tensor optimized with
optax through ``jax.grad`` of a ``lax.scan`` rollout — B independent
shooting problems solved in parallel per device (the reference solves one at a
time on one GPU). Material parameters are traced state, so randomizing them
per problem instance costs zero recompiles.
"""

import os
import pickle

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax


class TrajectorySolver:
    """Optimize an open-loop action sequence through ``env.step_diff``."""

    def __init__(
        self,
        env,
        horizon: int,
        lr: float = 0.02,
        optimizer: str = "adam",
        action_bounds=(-1.0, 1.0),
        loss_fn: Optional[Callable] = None,
    ):
        self.env = env
        self.horizon = horizon
        self.bounds = action_bounds
        if optimizer == "adam":
            self.optim = optax.adam(lr)
        elif optimizer == "momentum":
            self.optim = optax.sgd(lr, momentum=0.9)
        else:
            raise ValueError(optimizer)
        # default loss: negative sum of env rewards over the horizon
        self.loss_fn = loss_fn
        self._update = jax.jit(self._build_update())

    def _rollout_loss(self, actions, state):
        def body(state, a):
            obs, reward, done, info = self.env.step_diff(a, state)
            return info["state"], (reward, info["state"])

        final_state, (rewards, states) = jax.lax.scan(
            body, state, actions.swapaxes(0, 1), length=self.horizon
        )
        if self.loss_fn is not None:
            loss = self.loss_fn(final_state, rewards)
        else:
            loss = -rewards.sum(0).mean()
        return loss, (rewards, final_state)

    def _build_update(self):
        grad_fn = jax.grad(self._rollout_loss, has_aux=True)

        def update(actions, opt_state, state):
            g, (rewards, final_state) = grad_fn(actions, state)
            g = jnp.nan_to_num(g)
            updates, opt_state = self.optim.update(g, opt_state)
            actions = optax.apply_updates(actions, updates)
            actions = jnp.clip(actions, self.bounds[0], self.bounds[1])
            return actions, opt_state, rewards, final_state

        return update

    def init_actions(self, key, scale=0.01):
        B = self.env.batch_size
        return (
            jax.random.normal(key, (B, self.horizon, self.env.action_size)) * scale
        )

    def solve(self, state, key=None, n_iters: int = 50, actions=None, verbose=False):
        """Returns (best_actions, best_rewards, history)."""
        if actions is None:
            actions = self.init_actions(key if key is not None else jax.random.PRNGKey(0))
        opt_state = self.optim.init(actions)

        best_actions = actions
        best_reward = jnp.full((self.env.batch_size,), -jnp.inf)
        history = []
        for it in range(n_iters):
            actions, opt_state, rewards, final_state = self._update(
                actions, opt_state, state
            )
            total = rewards.sum(0)  # (B,)
            improved = total > best_reward
            best_reward = jnp.where(improved, total, best_reward)
            best_actions = jnp.where(improved[:, None, None], actions, best_actions)
            history.append(float(total.mean()))
            if verbose and it % 10 == 0:
                print(f"  solver it {it}: reward {float(total.mean()):.4f}")
        return best_actions, best_reward, history


class SolverNN:
    """Optimize a policy network through the simulator (solver_nn.py parity):
    the same rollout loss, but parameters of an MLP mapping obs -> action."""

    def __init__(self, env, horizon, lr=1e-3, hidden=(256, 256)):
        from unidom_tpu.models.mlp import make_policy_model

        self.env = env
        self.horizon = horizon
        self.model = make_policy_model(env.action_size, env.observation_size, hidden)
        self.optim = optax.adam(lr)
        self._update = jax.jit(self._build_update())

    def _rollout_loss(self, params, state):
        def body(state, _):
            obs = self.env.get_obs(state)
            a = jnp.tanh(self.model.apply(params, obs))
            obs, reward, done, info = self.env.step_diff(a, state)
            return info["state"], reward

        _, rewards = jax.lax.scan(body, state, None, length=self.horizon)
        return -rewards.sum(0).mean(), rewards

    def _build_update(self):
        grad_fn = jax.grad(self._rollout_loss, has_aux=True)

        def update(params, opt_state, state):
            g, rewards = grad_fn(params, state)
            g = jax.tree_util.tree_map(jnp.nan_to_num, g)
            updates, opt_state = self.optim.update(g, opt_state)
            return optax.apply_updates(params, updates), opt_state, rewards

        return update

    def solve(self, state, key=None, n_iters=100, verbose=False):
        params = self.model.init(key if key is not None else jax.random.PRNGKey(0))
        opt_state = self.optim.init(params)
        history = []
        for it in range(n_iters):
            params, opt_state, rewards = self._update(params, opt_state, state)
            history.append(float(rewards.sum(0).mean()))
            if verbose and it % 10 == 0:
                print(f"  solver_nn it {it}: reward {history[-1]:.4f}")
        return params, history


def generate_experts(
    env,
    out_dir: str,
    n_instances: int,
    horizon: int,
    solver_iters: int = 50,
    param_ranges: Optional[dict] = None,
    seed: int = 0,
    lr: float = 0.02,
):
    """Expert-data factory (solve_action parity, solver.py:116-418):
    randomize material parameters per instance *in traced state*, solve the
    trajectory, and pickle {action, params, point clouds, reward}.

    ``param_ranges`` maps state-field names (e.g. "mu", "lamda",
    "yield_stress" for MPM; "stiffness" for cloth) to (lo, hi) uniform
    ranges. The whole env batch solves one instance set in parallel.
    """
    os.makedirs(out_dir, exist_ok=True)
    solver = TrajectorySolver(env, horizon, lr=lr)
    key = jax.random.PRNGKey(seed)
    param_ranges = param_ranges or {}

    records = []
    for inst in range(n_instances):
        key, k_reset, k_param, k_act = jax.random.split(key, 4)
        _, state = env.reset(k_reset)
        drawn = {}
        for name, (lo, hi) in param_ranges.items():
            leaf = getattr(state, name)
            k_param, k = jax.random.split(k_param)
            draw = jax.random.uniform(k, (leaf.shape[0],), minval=lo, maxval=hi)
            draw = draw.reshape(leaf.shape[0], *([1] * (leaf.ndim - 1)))
            state = state._replace(**{name: jnp.broadcast_to(draw, leaf.shape).astype(leaf.dtype)})
            drawn[name] = np.asarray(draw).reshape(-1)

        x0 = getattr(env, "packed_x", None)
        pc_before = np.asarray(x0(state) if x0 else state.x)

        actions, best_reward, _ = solver.solve(state, k_act, n_iters=solver_iters)

        # roll the best actions forward for the final cloud
        s = state
        for t in range(horizon):
            _, _, _, info = env.step_diff(actions[:, t], s)
            s = info["state"]
        pc_after = np.asarray(x0(s) if x0 else s.x)

        rec = {
            "action": np.asarray(actions),
            "reward": np.asarray(best_reward),
            "params": drawn,
            "pc_before": pc_before,
            "pc_after": pc_after,
            "seed": seed,
            "instance": inst,
        }
        with open(os.path.join(out_dir, f"expert_{inst:04d}.pkl"), "wb") as f:
            pickle.dump(rec, f)
        records.append(rec)
        print(f"expert {inst}: reward {np.asarray(best_reward).mean():.4f} params "
              + " ".join(f"{k}={v.mean():.3g}" for k, v in drawn.items()))
    return records
