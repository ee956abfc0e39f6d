"""MPM simulator + env tests: conservation sanity, materials, primitives,
differentiability, focus computation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unidom_tpu.engine.mpm import (
    ELASTIC,
    PLASTIC_CLIP,
    VON_MISES,
    WATER,
    MPMConf,
    MPMSimulator,
)


def tiny_conf(**kw):
    d = dict(n_grid=32, dt=2e-4, steps=10, E=100.0, nu=0.1, res=(16, 16, 16))
    d.update(kw)
    return MPMConf(**d)


def make_sim(material=ELASTIC, batch=2, with_primitive=True, pos_control=False, **kw):
    conf = tiny_conf(**kw)
    sim = MPMSimulator(conf, batch, use_position_control=pos_control)
    state = sim.add_box(
        None, size=[0.12, 0.04, 0.08], init_pos=[0.25, 0.06, 0.25],
        material=material, density=1.0 if material == WATER else 2.5,
    )
    if with_primitive:
        from unidom_tpu.engine.primitives import create_primitive

        sim.register_primitive_sdf("box")
        p = create_primitive(conf.steps, friction=0.1, softness=666.0,
                             color=[0.5, 0.5, 0.5], size=[0.02, 0.02, 0.02],
                             init_pos=[0.25, 0.02, 0.15])
        state.primitives.append(p)
    state = sim.reset(state)
    return sim, state


class TestMPMSimulator:
    def test_reset_shapes(self):
        sim, state = make_sim()
        P = sim.n_particles
        assert P > 50
        assert state.x.shape == (2, P, 3)
        assert state.F.shape == (2, P, 3, 3)
        np.testing.assert_allclose(np.asarray(state.F[0, 0]), np.eye(3))

    def test_particles_fall_under_gravity(self):
        sim, state = make_sim(material=ELASTIC)
        y0 = float(state.x[0, :, 1].mean())
        action = jnp.zeros((2, 6))
        state, _ = sim.step_batch(state, action)
        y1 = float(state.x[0, :, 1].mean())
        assert y1 < y0  # falling
        assert np.all(np.isfinite(np.asarray(state.x)))

    def test_particles_stay_in_bounds(self):
        sim, state = make_sim(material=ELASTIC)
        action = jnp.zeros((2, 6))
        for _ in range(5):
            state, _ = sim.step_batch(state, action)
        x = np.asarray(state.x)
        assert np.all(np.isfinite(x))
        res = np.array(sim.conf.res) * sim.conf.dx
        assert x[..., 1].min() > -0.05  # ground holds (3-cell wall)

    def test_elastic_block_resists_deformation(self):
        """An elastic block's deformation gradient stays near identity at rest."""
        sim, state = make_sim(material=ELASTIC)
        action = jnp.zeros((2, 6))
        for _ in range(3):
            state, _ = sim.step_batch(state, action)
        F = np.asarray(state.F[0])
        assert np.abs(F - np.eye(3)).max() < 0.5

    def test_water_vs_elastic_differ(self):
        sim_w, state_w = make_sim(material=WATER, batch=1)
        sim_e, state_e = make_sim(material=ELASTIC, batch=1)
        action = jnp.zeros((1, 6))
        for _ in range(3):
            state_w, _ = sim_w.step_batch(state_w, action)
            state_e, _ = sim_e.step_batch(state_e, action)
        # water spreads farther than the elastic block
        spread_w = float(state_w.x[0, :, [0, 2]].std())
        spread_e = float(state_e.x[0, :, [0, 2]].std())
        assert np.isfinite(spread_w) and np.isfinite(spread_e)
        assert spread_w > spread_e * 0.9

    def test_plastic_clip_limits_sigma(self):
        sim, state = make_sim(material=PLASTIC_CLIP, batch=1)
        # squash: strong downward C
        squash = jnp.zeros((1, sim.n_particles, 3, 3)).at[:, :, 1, 1].set(-50.0)
        state = state._replace(C=squash)
        action = jnp.zeros((1, 6))
        state, _ = sim.step_batch(state, action)
        from unidom_tpu.ops.svd3 import svd3_jacobi

        _, sig, _ = svd3_jacobi(state.F[0])
        assert float(sig.min()) > 0.7  # clip floor 0.75 (+ integration slack)

    def test_von_mises_yields(self):
        sim, state = make_sim(material=VON_MISES, batch=1)
        state = state._replace(yield_stress=jnp.full_like(state.yield_stress, 0.1))
        shear = jnp.zeros((1, sim.n_particles, 3, 3)).at[:, :, 0, 1].set(30.0)
        state = state._replace(C=shear)
        action = jnp.zeros((1, 6))
        state, _ = sim.step_batch(state, action)
        assert np.all(np.isfinite(np.asarray(state.F)))

    def test_per_particle_parameters(self):
        """mu/lamda may be per-particle arrays (GenORM capability)."""
        sim, state = make_sim(material=ELASTIC, batch=1)
        P = sim.n_particles
        mu_pp = jnp.linspace(10.0, 100.0, P)
        la_pp = jnp.linspace(10.0, 100.0, P)
        state = state._replace(mu=mu_pp[None, :], lamda=la_pp[None, :])
        action = jnp.zeros((1, 6))
        state, _ = sim.step_batch(state, action)
        assert np.all(np.isfinite(np.asarray(state.x)))

    def test_primitive_moves_and_collides(self):
        sim, state = make_sim(material=ELASTIC, batch=1)
        action = jnp.zeros((1, 6)).at[0, 2].set(1.0)  # push +z
        p_before = np.asarray(state.primitives[0].position[0, 0])
        state, _ = sim.step_batch(state, action)
        p_after = np.asarray(state.primitives[0].position[0, 0])
        assert p_after[2] > p_before[2] + 0.5  # moved by ~action (clip to 1)

    def test_position_control(self):
        sim, state = make_sim(material=ELASTIC, batch=1, pos_control=True)
        action = jnp.zeros((1, 6)).at[0, 0].set(0.5)
        state, _ = sim.step_batch(state, action)
        assert np.all(np.isfinite(np.asarray(state.v)))

    def test_gradient_through_step(self):
        sim, state = make_sim(material=ELASTIC, batch=1, pos_control=True)

        def loss(action, state):
            s, _ = sim.step_batch(state, action)
            return s.x.sum()

        g = jax.jit(jax.grad(loss))(jnp.zeros((1, 6)).at[0, 2].set(0.2), state)
        g = np.asarray(g)
        assert np.all(np.isfinite(g))
        assert np.abs(g).sum() > 0

    def test_traced_params_no_recompile(self):
        sim, state = make_sim(material=ELASTIC, batch=1)
        step = jax.jit(sim.step_batch)
        action = jnp.zeros((1, 6))
        step(state._replace(mu=jnp.ones((1, 1)) * 20.0), action)
        n = step._cache_size()
        out = step(state._replace(mu=jnp.ones((1, 1)) * 80.0), action)
        assert step._cache_size() == n
        assert np.all(np.isfinite(np.asarray(out[0].x)))


class TestMPMEnvs:
    def test_whip_rope_smoke(self):
        from unidom_tpu.envs.mpm_tasks import WhipRopeEnv, MPMConf

        conf = MPMConf(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1,
                       res=(16, 16, 16), task="whip_rope", goal_path="")
        env = WhipRopeEnv(batch_size=2, seed=1, max_steps=5, conf=conf)
        obs, state = env.reset(jax.random.PRNGKey(1))
        assert obs.shape == (2, env.observation_size)

        actions = jnp.zeros((2, 6)).at[:, 0].set(0.5)
        obs, reward, done, info = env.step_diff(actions, state)
        assert reward.shape == (2,)
        assert np.all(np.isfinite(np.asarray(reward)))
        assert np.all(np.isfinite(np.asarray(info["state"].x)))

    def test_shape_rope_smoke_and_focus(self):
        from unidom_tpu.envs.mpm_tasks import ShapeRopeEnv, MPMConf

        conf = MPMConf(n_grid=64, dt=2e-4, steps=6, E=100.0, nu=0.1,
                       ground_friction=0.9, res=(32, 6, 32), task="shape_rope",
                       goal_path="")

        class SmallShapeRope(ShapeRopeEnv):
            PUSH_SUBSTEPS = 4
            DO_RESET_PUSHES = 1

        env = SmallShapeRope(batch_size=2, seed=1, max_steps=4, conf=conf)
        obs, state = env.reset(jax.random.PRNGKey(0))
        x = np.asarray(state.x)
        assert np.all(np.isfinite(x))
        # focus computation round-trips: cloud stays in world frame near init
        assert abs(x[0, :, 0].mean() - 0.5) < 0.2

        actions = env.random_policy(2)
        obs, reward, done, info = env.step_diff(jnp.asarray(actions), state)
        assert np.all(np.isfinite(np.asarray(reward)))

    def test_whip_rope_bptt_grad(self):
        from unidom_tpu.envs.mpm_tasks import WhipRopeEnv, MPMConf

        conf = MPMConf(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1,
                       res=(16, 16, 16), task="whip_rope", goal_path="")
        env = WhipRopeEnv(batch_size=1, seed=1, max_steps=5, conf=conf)
        obs, state = env.reset(jax.random.PRNGKey(1))

        def loss(actions, state):
            obs, reward, done, info = env.step_diff(actions, state)
            obs, reward, done, info = env.step_diff(actions, info["state"])
            return -reward.mean()

        g = jax.jit(jax.grad(loss))(jnp.ones((1, 6)) * 0.3, state)
        assert np.all(np.isfinite(np.asarray(g)))
        assert np.abs(np.asarray(g)).sum() > 0


class TestGradTest:
    def test_whip_rope_grad_test_utility(self):
        """The reference's grad_test BPTT sanity check (whip_rope_env.py:213)."""
        from unidom_tpu.envs.mpm_tasks import grad_test

        results = grad_test(n_chained_steps=2, n_iters=2)
        assert len(results) == 2


class TestDenseTransfer:
    """Tensor-product P2G/G2P must match the scatter path exactly (both
    directions, including the affine/APIC terms and gradients)."""

    def _pair(self):
        sim_d, state = make_sim(material=ELASTIC, batch=1, transfer="dense")
        sim_s, _ = make_sim(material=ELASTIC, batch=1, transfer="scatter")
        assert sim_d.transfer_mode == "dense"
        assert sim_s.transfer_mode == "scatter"
        return sim_d, sim_s, state

    def test_forward_parity(self):
        sim_d, sim_s, state = self._pair()
        state = state._replace(
            v=jax.random.normal(jax.random.PRNGKey(0), state.v.shape) * 0.05,
            C=jax.random.normal(jax.random.PRNGKey(1), state.C.shape) * 0.5,
        )
        action = jnp.zeros((1, 6)).at[0, 0].set(0.5)
        out_d, _ = sim_d.step_batch(state, action)
        out_s, _ = sim_s.step_batch(state, action)
        np.testing.assert_allclose(np.asarray(out_d.x), np.asarray(out_s.x),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(out_d.v), np.asarray(out_s.v),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out_d.C), np.asarray(out_s.C),
                                   rtol=1e-3, atol=1e-3)

    def test_grad_parity(self):
        sim_d, sim_s, state = self._pair()

        def loss(sim):
            def f(action, state):
                s, _ = sim.step_batch(state, action)
                return (s.x * 1.3).sum() + (s.v * 0.7).sum()
            return f

        a = jnp.zeros((1, 6)).at[0, 2].set(0.3)
        g_d = jax.grad(loss(sim_d))(a, state)
        g_s = jax.grad(loss(sim_s))(a, state)
        np.testing.assert_allclose(np.asarray(g_d), np.asarray(g_s),
                                   rtol=1e-3, atol=1e-7)


# true-resolution XLA-path smoke tests of the big-grid tasks


@pytest.mark.slow
def test_shape_elasto_true_res_xla_smoke():
    """One forward step_diff + one backward at the reference resolution
    (n_grid 96, res (48, 32, 48), ~33k particles) on the XLA path."""
    from unidom_tpu.envs.mpm_tasks import ShapeElastoPlasticEnv

    env = ShapeElastoPlasticEnv(batch_size=1)
    obs, state = env.reset(jax.random.PRNGKey(0))
    assert env.simulator.n_particles > 20000
    a = jnp.asarray(np.array([[0.45, 0.0, 0.5, 0.55, 0.0, 0.5]], np.float32))
    obs, reward, done, info = env.step_diff(a, state)
    assert np.isfinite(np.asarray(info["state"].x)).all()

    def loss(a):
        _, r, _, _ = env.step_diff(a, state)
        return -r.sum()

    g = jax.grad(loss)(a)
    assert np.isfinite(np.asarray(g)).all()


@pytest.mark.slow
def test_pour_soup_true_res_xla_smoke():
    """One forward step_diff at pour_soup's reference resolution
    (n_grid 128, res (128, 64, 128) ~= 1M cells) on the XLA path."""
    from unidom_tpu.envs.mpm_tasks import PourSoupEnv

    env = PourSoupEnv(batch_size=1)
    obs, state = env.reset(jax.random.PRNGKey(0))
    a = jnp.asarray(np.zeros((1, 6), np.float32))
    obs, reward, done, info = env.step_diff(a, state)
    assert np.isfinite(np.asarray(info["state"].x)).all()
