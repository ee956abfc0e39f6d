"""Cloth simulator + env tests: physics sanity, differentiability, parity
properties, memory modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unidom_tpu.engine.cloth import ClothConf, ClothSimulator
from unidom_tpu.envs.cloth_tasks import FoldCloth1Env, FoldCloth1ParaEnv


def small_conf(**kw):
    defaults = dict(N=20, stiffness=900.0, mem_saving_level=1, n_substeps=50)
    defaults.update(kw)
    return ClothConf(**defaults)


def rect_mask(N, h, w):
    m = np.zeros((N, N), dtype=np.float32)
    i0, j0 = (N - h) // 2, (N - w) // 2
    m[i0 : i0 + h, j0 : j0 + w] = 1.0
    return m


def identity_collision(x, v, idx_i, idx_j):
    return v


class TestClothSimulator:
    def make(self, batch=2, **kw):
        conf = small_conf(**kw)
        sim = ClothSimulator(conf, batch, identity_collision, rect_mask(conf.N, 6, 8))
        return sim, sim.reset()

    def test_topology(self):
        sim, state = self.make()
        assert sim.n_particles == 48
        assert (sim.H, sim.W) == (6, 8)
        assert state.x.shape == (2, 6, 8, 3)
        assert sim.pack(state.x[0]).shape == (48, 3)
        # interior particle has 8 valid neighbors, corner particle 3
        n_valid = np.asarray(sim.nbr_valid[..., 0]).sum(-1)
        assert n_valid.max() == 8
        assert n_valid.min() == 3

    def test_cloth_falls_and_rests_on_ground(self):
        sim, state = self.make()
        action = jnp.zeros((2, 8))
        for _ in range(5):
            state, _ = sim.step_batch(state, action)
        x = np.asarray(state.x)
        # x is clipped to [0, 1] *before* the final x += dt*v integration
        # (reference semantics), so the rest height dips ~1e-3 below 0
        assert np.all(x[..., 1] >= -0.01)
        assert np.all(x[..., 1] < 0.05)  # settled near the ground
        assert np.all(np.isfinite(x))

    def test_springs_preserve_shape(self):
        """A stiff cloth should not stretch much under gravity."""
        sim, state = self.make()
        action = jnp.zeros((2, 8))
        for _ in range(5):
            state, _ = sim.step_batch(state, action)
        # horizontal neighbor distance on the dense grid
        x = state.x[0]
        d = jnp.linalg.norm(x[:, 1:] - x[:, :-1], axis=-1)
        stretch = jnp.abs(d - sim.conf.cell_size) / sim.conf.cell_size
        assert float(stretch.max()) < 0.25

    def test_gripper_suction_moves_particles(self):
        sim, state = self.make()
        # place gripper-0 at a corner particle, suction ON (flag 0)
        corner = state.x[0, 0, 0]
        prim0 = jnp.concatenate([corner, jnp.array([0.05])])
        state = state._replace(primitive0=jnp.broadcast_to(prim0, (2, 4)))
        action = jnp.zeros((2, 8)).at[:, 1].set(2.0)  # pull up
        before_y = float(state.x[0, 0, 0, 1])
        for _ in range(3):
            state, _ = sim.step_batch(state, action)
        after_y = float(state.x[0, 0, 0, 1])
        assert after_y > before_y + 0.05

    @pytest.mark.parametrize("level", [0, 1, 2])
    def test_mem_saving_levels_same_forward(self, level):
        sim, state = self.make(batch=1, mem_saving_level=level)
        action = jnp.ones((1, 8)) * 0.3
        out, _ = sim.step_batch(state, action)
        sim0, state0 = self.make(batch=1, mem_saving_level=0)
        ref, _ = sim0.step_batch(state0, action)
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-6)

    def _grip_loss(self, sim):
        """Action gradient of a robot step whose gripper holds a corner."""
        def loss(action, state):
            prim0 = jnp.concatenate([state.x[:, 0, 0], jnp.full((state.x.shape[0], 1), 0.05)], -1)
            s, _ = sim.step_batch(state._replace(primitive0=prim0), action)
            return jnp.sum(s.x[..., 1]) + 0.1 * jnp.sum(s.v)
        return jax.jit(jax.grad(loss))

    @pytest.mark.parametrize("level", [0, 1, 2])
    def test_mem_saving_levels_same_grad(self, level):
        action = jnp.ones((1, 8)).at[:, 3].set(0.0) * 0.3
        sim, state = self.make(batch=1, mem_saving_level=level)
        sim0, state0 = self.make(batch=1, mem_saving_level=0)
        g = self._grip_loss(sim)(action, state)
        g0 = self._grip_loss(sim0)(action, state0)
        assert np.abs(np.asarray(g0)).sum() > 0
        np.testing.assert_allclose(np.asarray(g), np.asarray(g0), rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize("batch", [1, 2, 5])
    def test_batch_invariance(self, batch):
        """Env i's step and action gradient do not depend on the batch size
        it is computed in."""
        actions = jnp.asarray(np.random.RandomState(0).uniform(-0.5, 0.5, (5, 8)),
                              jnp.float32).at[:, 3].set(0.0)
        sim5, state5 = self.make(batch=5)
        sim, state = self.make(batch=batch)
        ref, _ = sim5.step_batch(state5, actions)
        out, _ = sim.step_batch(state, actions[:batch])
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x[:batch]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(out.v), np.asarray(ref.v[:batch]),
                                   rtol=1e-6, atol=1e-7)
        g_ref = self._grip_loss(sim5)(actions, state5)
        g = self._grip_loss(sim)(actions[:batch], state)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref[:batch]),
                                   rtol=1e-5, atol=1e-7)

    def test_gradients_flow_and_finite(self):
        sim, state = self.make(batch=1)
        # grip a corner particle so the action actually touches the cloth
        corner = state.x[0, 0, 0]
        prim0 = jnp.concatenate([corner, jnp.array([0.05])])
        state = state._replace(primitive0=jnp.broadcast_to(prim0, (1, 4)))

        def loss(action, state):
            s, _ = sim.step_batch(state, action)
            s, _ = sim.step_batch(s, action)
            return jnp.sum(s.x[..., 1])

        g = jax.jit(jax.grad(loss))(jnp.zeros((1, 8)).at[:, 1].set(0.5), state)
        g = np.asarray(g)
        assert np.all(np.isfinite(g))
        assert np.abs(g).sum() > 0

    def test_stiffness_is_traced_no_recompile(self):
        """Changing stiffness must not retrigger compilation (para training)."""
        sim, state = self.make(batch=1)
        # perturb velocities so spring forces are non-zero and stiffness matters
        state = state._replace(
            v=jax.random.normal(jax.random.PRNGKey(0), state.v.shape) * 0.5
        )
        step = jax.jit(sim.step_batch)
        action = jnp.zeros((1, 8))
        out1, _ = step(state._replace(stiffness=jnp.ones(1) * 500.0), action)
        n_compiles = step._cache_size()
        out2, _ = step(state._replace(stiffness=jnp.ones(1) * 1500.0), action)
        assert step._cache_size() == n_compiles
        # and the dynamics actually differ
        assert not np.allclose(np.asarray(out1.x), np.asarray(out2.x))


class TestClothEnv:
    @pytest.fixture(scope="class")
    def env(self):
        conf = ClothConf(N=40, stiffness=900.0, mem_saving_level=1, task="t", goal_path="")
        return FoldCloth1Env(batch_size=2, conf=conf)

    def test_reset_and_obs(self, env):
        obs, state = env.reset(jax.random.PRNGKey(0))
        assert obs.shape == (2, env.observation_size)
        assert state.x.shape[0] == 2
        assert env.packed_x(state).shape == (2, env.n_particles, 3)

    def test_pnp_expansion(self, env):
        _, state = env.reset(jax.random.PRNGKey(0))
        actions = jnp.zeros((2, 6)).at[:, 0].set(0.5)
        sub = env.get_pnp_actions(actions, state)
        assert sub.shape == (40, 2, 8)
        # release phase has suction flag 1
        assert float(sub[-1, 0, 3]) == 1.0

    def test_step_diff(self, env):
        _, state = env.reset(jax.random.PRNGKey(0))
        actions = env.get_random_fold_action(state)
        obs, reward, done, info = env.step_diff(actions, state)
        assert obs.shape == (2, env.observation_size)
        assert reward.shape == (2,)
        assert np.all(np.isfinite(np.asarray(reward)))
        assert not bool(np.asarray(done).any())
        assert info["state"].cur_step[0] == 1
        # shaped progress signal (reference cloth_env.py:227-228):
        # old_chamfer - new_chamfer + 0.1 * contact_distance
        assert info["real_reward"].shape == (2,)
        assert np.all(np.isfinite(np.asarray(info["real_reward"])))

    def test_episode_terminates(self, env):
        _, state = env.reset(jax.random.PRNGKey(0))
        for i in range(3):
            actions = env.get_random_fold_action(state)
            obs, reward, done, info = env.step_diff(actions, state)
            state = info["state"]
        assert bool(np.asarray(done).all())

    def test_bptt_gradient(self, env):
        _, state = env.reset(jax.random.PRNGKey(0))

        def loss(actions, state):
            obs, reward, done, info = env.step_diff(actions, state)
            return -reward.mean()

        actions = env.get_random_fold_action(state)
        g = jax.jit(jax.grad(loss))(actions, state)
        assert np.all(np.isfinite(np.asarray(g)))
        assert np.abs(np.asarray(g)).sum() > 0


class TestParaEnv:
    def test_param_in_obs(self):
        conf = ClothConf(N=40, stiffness=900.0, mem_saving_level=1, task="t", goal_path="")
        env = FoldCloth1ParaEnv(batch_size=1, conf=conf, eval_min_max_stiff=(100.0, 2000.0))
        obs, state = env.reset(jax.random.PRNGKey(0))
        assert obs.shape[-1] == env.n_particles * 3 + 8 + 1
        np.testing.assert_allclose(
            float(obs[0, -1]), (900.0 - 100.0) / 1900.0, rtol=1e-5
        )
