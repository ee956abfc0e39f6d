"""Cloth task environments: pick-and-place macro actions + chamfer reward.

Semantics follow the reference env layer
(DaXBench/daxbench/core/envs/basic/cloth_env.py:20-333 and
cloth_env_para.py): a 6-DoF macro action (pick xyz, place xyz) is expanded
into 40 gripper sub-actions (3 down, 10 up, 20 move, 7 release), each
sub-action driving 50 simulator substeps; reward is
``e^(-10 * chamfer(x, goal)) * 0.99^t`` with an optional contact-distance
auxiliary term.

The "para" capability (stiffness-conditioned observations,
cloth_env_para.py:123-133) is folded into the base class behind
``param_obs=True`` rather than forked into a parallel class hierarchy:
stiffness is traced state, so randomizing it never re-traces.
"""

import glob
import math
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from unidom_tpu.engine.cloth import ClothConf, ClothSimulator, ClothState
from unidom_tpu.ops.metrics import chamfer


class ClothEnv:
    """Batched differentiable cloth environment (pure-functional step/reset)."""

    PARTICLE = "PARTICLE"
    DEPTH = "DEPTH"

    # trainer contracts (replacing the reference's isinstance switches,
    # apg.py:90-91, 133-134, 185-186, 288-307)
    action_squash = "sigmoid"  # post-sample sigmoid on sampled actions
    reset_mode = "reset"  # fresh vmapped reset(key) every training iteration

    def __init__(
        self,
        conf: ClothConf,
        batch_size: int,
        max_steps: int,
        aux_reward: bool = False,
        param_obs: bool = False,
        eval_min_max_stiff=(10.0, 1800.0),
        obs_type: str = "PARTICLE",
    ):
        cloth_mask = self.create_cloth_mask(conf)
        self.simulator = ClothSimulator(conf, batch_size, self.get_collision_func(), cloth_mask)

        self.conf = conf
        self.aux_reward = aux_reward
        self.param_obs = param_obs
        self.eval_min_max_stiff = tuple(eval_min_max_stiff)
        self.cloth_mask = self.simulator.cloth_mask
        self.max_steps = max_steps
        self.batch_size = batch_size
        self.action_size = 6

        num_p = self.simulator.n_particles
        self.n_particles = num_p
        if obs_type not in (self.PARTICLE, self.DEPTH):
            raise NotImplementedError(f"obs_type {obs_type!r}")
        self.obs_type = obs_type
        if obs_type == self.DEPTH:
            # (320, 320, 1) heightmap (cloth_env.py:99-117)
            self.observation_size = 320 * 320
        else:
            self.observation_size = num_p * 3 + 8 + (1 if param_obs else 0)
        self.seed(conf.seed)

        self.goal = self._load_goal(conf.goal_path)

        self.step_diff = jax.jit(self.build_step_diff())
        self.reset = self.build_reset()

    # -------------------------------------------------------------- #

    def create_cloth_mask(self, conf):
        raise NotImplementedError

    def get_collision_func(self):
        def collision_func(x, v, idx_i, idx_j):
            return v

        return collision_func

    def seed(self, seed):
        self.simulator.key_global = jax.random.PRNGKey(seed)
        np.random.seed(seed)

    def _load_goal(self, goal_path):
        if goal_path and os.path.exists(goal_path):
            return jnp.asarray(np.load(goal_path))
        if goal_path:  # an explicit path that is missing is worth a warning;
            # an empty path means "no goal requested" and must stay silent on
            # library paths (stdout is the bench JSON contract).
            print(f"Warning: goal file {goal_path!r} does not exist!", file=sys.stderr)
        return jnp.zeros((1, 3))

    # -------------------------------------------------------------- #
    # observations
    # -------------------------------------------------------------- #

    def packed_x(self, state: ClothState):
        """(B, P, 3) particle view of the dense state (the reference's native
        layout; used for obs, rewards, and the robot bridge)."""
        return jax.vmap(self.simulator.pack)(state.x)

    def get_obs(self, state: ClothState):
        """PARTICLE: positions + both gripper states (+ normalized stiffness
        when param-conditioned). DEPTH: (320, 320, 1) top-down heightmap
        (the reference's obs_type switch, cloth_env.py:97-132)."""
        if self.obs_type == self.DEPTH:
            return self.state_to_depth(state)

        def one(x, p0, p1, stiffness):
            parts = [self.simulator.pack(x).reshape(-1), p0, p1]
            if self.param_obs:
                lo, hi = self.eval_min_max_stiff
                parts.append(((stiffness - lo) / (hi - lo)).reshape(1))
            return jnp.concatenate(parts, axis=-1)

        return jax.vmap(one)(state.x, state.primitive0, state.primitive1, state.stiffness)

    def state_to_depth(self, state: ClothState, width=320, height=320):
        """Top-down heightmap observation (cloth_env.py:71-92)."""
        pixel_size = 0.003125
        z_offset = 0.01

        def one(x):
            x = self.simulator.pack(x)
            points = x + jnp.array([[0.0, z_offset, 0.0]])
            order = jnp.argsort(points[..., 1])
            points = points[order]
            px = jnp.clip(jnp.floor(points[:, 0] / pixel_size).astype(jnp.int32), 0, width - 1)
            py = jnp.clip(jnp.floor(points[:, 2] / pixel_size).astype(jnp.int32), 0, height - 1)
            hm = jnp.zeros((width, height), dtype=jnp.float32)
            hm = hm.at[py, px].set(points[:, 1])
            return hm[..., None]

        return jax.vmap(one)(state.x)

    # -------------------------------------------------------------- #
    # macro-action expansion
    # -------------------------------------------------------------- #

    @staticmethod
    @partial(jax.vmap, in_axes=(0, 0), out_axes=1)
    def get_pnp_actions(actions, state: ClothState):
        """Expand (6,) pick/place into (40, 8) gripper sub-actions
        (cloth_env.py:134-173): 3 down + 10 up + 20 move + 7 release; second
        gripper idle."""
        pick, place = actions[:3], actions[3:]
        pick = pick.at[1].set(0.0)
        place = place.at[1].set(0.0)

        act_down = pick - state.primitive0[:3]
        act_down = jnp.ones(4).at[:3].set(act_down / 3.0)
        act_down = jnp.broadcast_to(act_down, (3, 4))

        act_up = jnp.array([0.0, 0.06 / 10.0, 0.0, 0.0])
        act_up = jnp.broadcast_to(act_up, (10, 4))

        act_move = (place - pick).at[1].set(0.0) / 20.0
        act_move = jnp.zeros(4).at[:3].set(act_move)
        act_move = jnp.broadcast_to(act_move, (20, 4))

        act_release = jnp.broadcast_to(jnp.array([0.0, 0.0, 0.0, 1.0]), (7, 4))

        sub = jnp.concatenate([act_down, act_up, act_move, act_release], axis=0)
        return jnp.concatenate([sub, jnp.zeros_like(sub)], axis=1)  # (40, 8)

    # -------------------------------------------------------------- #
    # step / reset
    # -------------------------------------------------------------- #

    def build_step_diff(self):
        def step_diff(actions, state: ClothState):
            pickup_place = actions[..., :3]
            old_chamfer_distance = chamfer(self.packed_x(state), self.goal)
            contact_distance = jnp.sqrt(
                jnp.sum((pickup_place[:, None, :] - self.packed_x(state)) ** 2, -1)
            ).min(-1)

            sub_actions = self.get_pnp_actions(actions, state)
            state, state_list = jax.lax.scan(
                self.simulator.step_batch, state, sub_actions, length=sub_actions.shape[0]
            )
            state = state._replace(cur_step=state.cur_step + 1)
            obs = self.get_obs(state)

            if self.conf.use_substep_obs:
                obs_list = jax.vmap(self.get_obs)(state_list)
            else:
                obs_list = obs

            done = state.cur_step >= self.max_steps
            chamfer_distance = chamfer(self.packed_x(state), self.goal)
            reward = math.e ** (-chamfer_distance * 10.0)
            if self.aux_reward:
                reward = reward + math.e ** (-contact_distance)
            reward = reward * 0.99**state.cur_step

            info = {"state": state, "obs_list": obs_list, "state_list": state_list}
            # shaped progress signal in info (reference cloth_env.py:227-228);
            # not consumed by the trainer, part of the env API surface
            info["real_reward"] = (
                old_chamfer_distance - chamfer_distance + 0.1 * contact_distance
            )
            return obs, reward, done, info

        return step_diff

    def build_reset(self):
        init_state = self.simulator.reset()

        def reset(key):
            key, _ = jax.random.split(key)
            shift = jax.random.normal(key, (2,)) * 0.05
            new_x = init_state.x.at[..., [0, 2]].add(shift)
            state = init_state._replace(x=new_x)
            return self.get_obs(state), state

        return reset

    # -------------------------------------------------------------- #
    # misc API parity
    # -------------------------------------------------------------- #

    def get_x_grid(self, state: ClothState):
        return self.simulator.get_x_grid(state.x)

    def collect_goal(self, out_dir=None):
        """Interactive goal collection (cloth_env.py:245-272): click pick/
        place pairs until two clicks coincide; saves the final cloud."""
        assert self.batch_size == 1
        from unidom_tpu.utils.expert_ui import get_expert_start_end_cloth

        while True:
            self.simulator.key_global, _ = jax.random.split(self.simulator.key_global)
            obs, state = self.reset(self.simulator.key_global)
            valid = True
            while True:
                self.render(state)
                actions = get_expert_start_end_cloth(
                    np.asarray(self.get_x_grid(state)), np.asarray(self.cloth_mask)
                )
                d = np.linalg.norm(actions[0, :3] - actions[0, 3:])
                if d < 1e-3:
                    break
                if d > 0.8:
                    valid = False
                    break
                _, reward, _, info = self.step_diff(jnp.asarray(actions), state)
                state = info["state"]
                print("reward", reward)
            if valid:
                out_dir = out_dir or os.path.join("goals", self.conf.task)
                os.makedirs(out_dir, exist_ok=True)
                np.save(os.path.join(out_dir, "goal.npy"),
                        np.asarray(self.packed_x(state))[0])
                return os.path.join(out_dir, "goal.npy")

    def collect_expert_demo(self, num_demo=10, out_dir=None):
        """Interactive demo collection (cloth_env.py:274-321): records
        (obs, action, state) episodes as pickles."""
        assert self.batch_size == 1
        import pickle

        from unidom_tpu.utils.expert_ui import get_expert_start_end_cloth

        out_dir = out_dir or os.path.join("expert_demo", self.conf.task)
        os.makedirs(out_dir, exist_ok=True)
        i = len(glob.glob(os.path.join(out_dir, "*.pkl")))
        while i < num_demo:
            self.simulator.key_global, _ = jax.random.split(self.simulator.key_global)
            obs, state = self.reset(self.simulator.key_global)
            demo = {"obs": [], "action": [], "state": []}
            valid = True
            while True:
                self.render(state)
                actions = get_expert_start_end_cloth(
                    np.asarray(self.get_x_grid(state)), np.asarray(self.cloth_mask)
                )
                d = np.linalg.norm(actions[0, :3] - actions[0, 3:])
                if d < 1e-3:
                    break
                if d > 0.8:
                    valid = False
                    break
                demo["state"].append(state)
                demo["action"].append(actions)
                demo["obs"].append(obs)
                obs, reward, _, info = self.step_diff(jnp.asarray(actions), state)
                state = info["state"]
            if valid:
                with open(os.path.join(out_dir, f"demo_{i}.pkl"), "wb") as f:
                    pickle.dump(demo, f)
                i += 1

    def get_random_fold_action(self, state: ClothState):
        """Random pick/place pair sampled from current particles
        (cloth_env.py:323-333; uses numpy RNG like the reference)."""
        x = self.packed_x(state)
        num_particle = x.shape[1]
        batch_size = x.shape[0]
        batch_idx = jnp.arange(batch_size)
        st = np.random.randint(0, num_particle, size=(batch_size,))
        ed = np.random.randint(0, num_particle, size=(batch_size,))
        return jnp.concatenate((x[batch_idx, st], x[batch_idx, ed]), axis=-1)

    def render(self, state: ClothState, visualize=False):
        from unidom_tpu.render.mesh import MeshRenderer

        if not hasattr(self, "_renderer"):
            self._renderer = MeshRenderer()
        return self._renderer.render(
            np.asarray(self.get_x_grid(state)[0]),
            np.asarray(self.simulator.indices),
            np.asarray(state.primitive0[0]),
            visualize,
        )

    def step_with_render(self, actions, state: ClothState, visualize=False):
        """step_diff plus a frame per gripper sub-action
        (cloth_env.py:189-199)."""
        obs, reward, done, info = self.step_diff(actions, state)
        sub_actions = self.get_pnp_actions(actions, state)
        img_list = []
        for action in sub_actions:
            state, _ = self.simulator.step_batch(state, action)
            rgb, depth = self.render(state, visualize)
            img_list.append(rgb)
        info["img_list"] = img_list
        return obs, reward, done, info
