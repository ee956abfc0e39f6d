"""APG trainer tests: models, sharded minimize step, reward improvement
signal, checkpoint round-trip — all on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from unidom_tpu.algorithms.apg import build_apg
from unidom_tpu.engine.cloth import ClothConf
from unidom_tpu.envs.cloth_tasks import FoldCloth1Env
from unidom_tpu.models.distribution import NormalTanhDistribution
from unidom_tpu.models.mlp import make_policy_model
from unidom_tpu.models.normalizer import (
    create_observation_normalizer,
    normalize,
    update_normalizer,
)
from unidom_tpu.parallel.mesh import make_env_mesh


class TestModels:
    def test_policy_shapes(self):
        dist = NormalTanhDistribution(6)
        model = make_policy_model(dist.param_size, obs_size=20, hidden=(32, 16))
        params = model.init(jax.random.PRNGKey(0))
        logits = model.apply(params, jnp.zeros((4, 20)))
        assert logits.shape == (4, 12)
        a = dist.sample(logits, jax.random.PRNGKey(1))
        assert a.shape == (4, 6)
        assert np.all(np.abs(np.asarray(a)) <= 1.0)

    def test_distribution_mode_deterministic(self):
        dist = NormalTanhDistribution(3)
        logits = jnp.ones((2, 6))
        m = dist.mode(logits)
        np.testing.assert_allclose(np.asarray(m), np.tanh(1.0), rtol=1e-6)

    def test_normalizer_converges_to_moments(self):
        params = create_observation_normalizer(4)
        key = jax.random.PRNGKey(0)
        data = jax.random.normal(key, (1000, 4)) * 3.0 + 2.0
        for i in range(10):
            params = update_normalizer(params, data[i * 100 : (i + 1) * 100])
        out = normalize(params, data)
        assert abs(float(out.mean())) < 0.05
        assert abs(float(out.std()) - 1.0) < 0.05

    def test_normalizer_cross_device_matches_serial(self):
        """The sharded update must equal a single-device update over the
        concatenated batch — including the between-device variance term
        sum_d count_d*(mean_d - mean)^2 that per-shard m2 accumulation would
        drop (worst when shards have very different means)."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        mesh = make_env_mesh()
        n = mesh.devices.size
        # give each device shard a wildly different mean
        data = (
            jax.random.normal(jax.random.PRNGKey(0), (n * 4, 3))
            + jnp.arange(n * 4, dtype=jnp.float32)[:, None] * 10.0
        )
        params = create_observation_normalizer(3)

        sharded_update = jax.jit(
            shard_map(
                lambda p, o: update_normalizer(p, o, axis_name="env"),
                mesh=mesh,
                in_specs=(P(), P("env")),
                out_specs=P(),
                check_vma=False,
            )
        )
        got = sharded_update(params, data)
        want = update_normalizer(params, data)
        np.testing.assert_allclose(float(got.count), float(want.count))
        np.testing.assert_allclose(
            np.asarray(got.mean), np.asarray(want.mean), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(got.m2), np.asarray(want.m2), rtol=1e-4
        )


@pytest.fixture(scope="module")
def tiny_env():
    # gripper_radius must exceed half the particle spacing (1/N) or the
    # pick never captures cloth and the policy gradient is legitimately zero
    conf = ClothConf(N=20, stiffness=900.0, mem_saving_level=1, n_substeps=10,
                     gripper_radius=0.08, task="tiny", goal_path="")
    return FoldCloth1Env(batch_size=1, conf=conf)  # 1 env per device


class TestAPG:
    def test_minimize_step_on_mesh(self, tiny_env):
        mesh = make_env_mesh()  # 8 CPU devices
        init_ts, minimize, reset_batch, run_eval = build_apg(
            tiny_env, episode_length=2, mesh=mesh
        )
        ts = init_ts(0)
        first_state = reset_batch(jax.random.PRNGKey(0))
        assert first_state.x.shape[0] == 8  # global batch = 8 x 1

        ts2, metrics = minimize(ts, first_state)
        assert np.isfinite(float(metrics["reward"]))
        assert np.isfinite(float(metrics["grad_norm"]))
        # params actually moved
        delta = jax.tree_util.tree_map(
            lambda a, b: float(jnp.abs(a - b).max()), ts.policy_params, ts2.policy_params
        )
        assert max(jax.tree_util.tree_leaves(delta)) > 0

    def test_clip_then_pmean_ordering(self):
        """The trainer's collective pipeline (nan_to_num -> per-shard clip ->
        pmean) must match the hand-computed result. (Exact 8-dev vs 1-dev
        trainer equality does not hold by design: a replicated key draws
        per-shard noise of local batch shape, mirroring the reference's pmap
        semantics.)"""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from unidom_tpu.ops.gradops import global_norm_clip

        mesh = make_env_mesh()

        def per_shard(g):
            g = jax.tree_util.tree_map(jnp.nan_to_num, g)
            g = global_norm_clip(g, 0.3)
            return jax.lax.pmean(g, axis_name="env")

        f = shard_map(per_shard, mesh=mesh, in_specs=P("env"), out_specs=P(),
                      check_vma=False)
        # 8 shards: one huge (clipped), one NaN (scrubbed), rest small
        g = jnp.ones((8, 4)) * 0.01
        g = g.at[0].set(100.0).at[1].set(jnp.nan)
        out = np.asarray(jax.jit(f)(g))
        expected = (0.3 / np.sqrt(4) + 0.0 + 6 * 0.01) / 8.0
        np.testing.assert_allclose(out, expected, rtol=1e-5)

    def test_eval_rollout(self, tiny_env):
        init_ts, _, _, run_eval = build_apg(tiny_env, 2, mesh=make_env_mesh(1))
        ts = init_ts(0)
        _, state = tiny_env.reset(jax.random.PRNGKey(3))
        _, actions, rewards = run_eval(
            ts.policy_params, ts.normalizer_params, state, jax.random.PRNGKey(1)
        )
        assert rewards.shape == (tiny_env.max_steps, 1)
        assert np.all(np.isfinite(np.asarray(rewards)))

    def test_sigmoid_squash_applied(self, tiny_env):
        """Cloth envs squash sampled actions into (0, 1)."""
        assert tiny_env.action_squash == "sigmoid"

    def test_training_reduces_loss_signal(self, tiny_env):
        """A few iterations should produce finite, varying rewards and
        nonzero gradients (full convergence is the bench's job)."""
        mesh = make_env_mesh()
        init_ts, minimize, reset_batch, _ = build_apg(
            tiny_env, episode_length=2, learning_rate=3e-3, mesh=mesh
        )
        ts = init_ts(0)
        key = jax.random.PRNGKey(0)
        grads = []
        for i in range(3):
            key, k = jax.random.split(key)
            state = reset_batch(k)
            ts, metrics = minimize(ts, state)
            grads.append(float(metrics["grad_norm"]))
        assert all(np.isfinite(g) for g in grads)
        assert any(g > 0 for g in grads)

    def test_normalize_obs_updates_and_applies(self, tiny_env):
        """--normalize_obs wires the running normalizer into the sharded
        update: statistics accumulate (psum over the env axis, identical on
        every replica) and the normalized policy input stays finite."""
        mesh = make_env_mesh()
        init_ts, minimize, reset_batch, _ = build_apg(
            tiny_env, episode_length=2, mesh=mesh, normalize_obs=True
        )
        ts = init_ts(0)
        assert float(ts.normalizer_params.count) == 0.0
        state = reset_batch(jax.random.PRNGKey(0))
        ts2, metrics = minimize(ts, state)
        # (1 reset + 2 scan steps) x 8 envs of observations folded in
        assert float(ts2.normalizer_params.count) == 24.0
        assert np.all(np.isfinite(np.asarray(ts2.normalizer_params.mean)))
        assert float(jnp.abs(ts2.normalizer_params.mean).max()) > 0
        ts3, metrics = minimize(ts2, state)
        assert float(ts3.normalizer_params.count) == 48.0
        assert np.isfinite(float(metrics["reward"]))

    def test_eval_gif(self, tiny_env, tmp_path):
        """save_gif writes a real animated GIF from the eval rollout
        (reference apg.py:318-330)."""
        from unidom_tpu.algorithms.apg import _write_eval_gif

        init_ts, _, _, run_eval = build_apg(tiny_env, 2, mesh=make_env_mesh(1))
        ts = init_ts(0)
        _, state = tiny_env.reset(jax.random.PRNGKey(3))
        _, actions, _ = run_eval(
            ts.policy_params, ts.normalizer_params, state, jax.random.PRNGKey(1)
        )
        path = _write_eval_gif(tiny_env, state, actions, str(tmp_path / "eval.gif"))
        import imageio

        frames = imageio.mimread(path)
        # animated: many frames survive GIF re-encode (writer may merge
        # identical consecutive frames); 3 macro steps x 40 sub-actions in
        assert len(frames) > tiny_env.max_steps
        assert frames[0].shape[-1] in (3, 4)
