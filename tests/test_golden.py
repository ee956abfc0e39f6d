"""Golden-trajectory regression against the reference's recorded rollouts.

Fixtures under tests/fixtures/ are decoded from the reference's own data
(scripts/extract_reference_fixtures.py):

- fold_cloth1_demo*.npz — human expert demos recorded through the reference
  engine (DaXBench expert_demo/fold_cloth1/demo_*.pkl; collection loop at
  cloth_env.py:274-321). The ``state`` entries are the engine states
  *before* each pick-and-place action, so x[0] is the reset state and
  x[t>0] is the cloth after replaying actions[:t].
- calibration_rope_*.npz — real-robot rope point clouds around one
  pick-and-place push (exp/calibration_data/*.pkl, used by
  exp/calibrate.py:65-166).

Replaying the same raw pnp actions through this engine must land on the
reference's recorded particle clouds: that pins the full contract chain
(reset geometry, pnp 40-sub-action expansion, 50-substep spring physics,
friction, grippers) to the reference numerically, not just structurally.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import unidom_tpu
from unidom_tpu.ops.metrics import chamfer

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    path = os.path.join(FIXTURES, name)
    if not os.path.exists(path):
        pytest.skip(f"fixture {name} not extracted")
    return np.load(path)


@pytest.mark.parametrize("idx", [0, 1])
def test_fold_cloth1_demo_replay(idx):
    demo = _load(f"fold_cloth1_demo{idx}.npz")
    actions, ref_x = demo["actions"], demo["x"]

    env = unidom_tpu.make_env("fold_cloth1", batch_size=1, seed=0)
    _, state = env.reset(jax.random.PRNGKey(0))

    # reset geometry: same flat cloth, same packed ordering, up to the
    # reference's random global xz offset (cloth_env.py:181-183 adds
    # normal(key,(2,))*0.05 per reset). De-mean to compare shape, then
    # translate our state onto the recorded offset so the recorded world-
    # coordinate pnp actions apply identically.
    ours = np.asarray(env.packed_x(state))[0]
    assert ours.shape == ref_x[0].shape
    np.testing.assert_allclose(
        ours - ours.mean(0), ref_x[0] - ref_x[0].mean(0), atol=1e-5
    )
    delta = (ref_x[0].mean(0) - ours.mean(0)).astype(np.float32)
    state = state._replace(x=state.x + delta)
    np.testing.assert_allclose(
        np.asarray(env.packed_x(state))[0], ref_x[0], atol=1e-5
    )

    # replay the expert actions; each recorded state is pre-action, so
    # after applying actions[t] we must match ref_x[t + 1]
    step = jax.jit(env.step_diff)
    for t in range(actions.shape[0] - 1):
        act = actions[t : t + 1].astype(np.float32)
        _, _, _, info = step(act, state)
        state = info["state"]
        ours = np.asarray(env.packed_x(state))[0]
        d = float(chamfer(ours[None], ref_x[t + 1])[0])
        # the engines share operator semantics but not layout / summation
        # order / friction branch tie-breaks; 2000 contact-rich substeps per
        # action amplify f32 noise to ~half a particle spacing (measured
        # 0.005-0.007). A broken contract (pnp expansion, friction sign,
        # gripper suction) lands >= 0.05, so 0.01 separates drift from bugs.
        assert d < 1e-2, (t, d)


def test_fold_cloth1_demo_obs_contract():
    demo = _load("fold_cloth1_demo0.npz")
    env = unidom_tpu.make_env("fold_cloth1", batch_size=1, seed=0)
    _, state = env.reset(jax.random.PRNGKey(0))
    obs = np.asarray(env.get_obs(state))
    assert obs.shape[-1] == demo["obs"].shape[-1] == 1544
    # particle block of the observation matches the recorded reset obs up
    # to the reference's random global reset offset (cloth_env.py:181-183)
    ref_particles = demo["obs"][0][: 512 * 3].reshape(512, 3)
    ours = obs[0][: 512 * 3].reshape(512, 3)
    np.testing.assert_allclose(
        ours - ours.mean(0), ref_particles - ref_particles.mean(0), atol=1e-5
    )


def test_calibration_rope_replay():
    """Sim-vs-real: replay the recorded pick-and-place push from the real
    rope pose and check the simulated rope tracks the real after-cloud
    (exp/calibrate.py semantics: init from endpoints, replay, compare)."""
    fix = _load("calibration_rope_0.npz")
    from unidom_tpu.serve.calibrate import replay_episode

    result = replay_episode(
        before=fix["before"], after=fix["after"],
        pick=fix["pick"], place=fix["place"],
    )
    # the real clouds are dense scans (~1k points) of a ~0.5 m rope; the
    # simulated rope must end closer to the real after-state than it began
    assert result["chamfer_after"] < result["chamfer_before"], result
    assert np.isfinite(result["chamfer_after"])


def test_goal_assets_match_reference():
    """The shipped goal clouds ARE the reference's task definitions
    (adopted verbatim by scripts/adopt_goals.py; round-2 verdict found
    regenerated goals made every reward number incomparable). shape_rope_hard
    trains against the shape_rope goal, as the reference env does
    (shape_rope_hard_env.py:8 aliases ShapeRopeEnv's conf, task="shape_rope").
    """
    ref_root = "/root/reference/DaXBench/daxbench/core/envs/goals"
    if not os.path.isdir(ref_root):
        pytest.skip("reference tree not mounted")
    asset_root = os.path.join(
        os.path.dirname(unidom_tpu.__file__), "assets", "goals"
    )
    adopted = {
        "fold_cloth1": "fold_cloth1",
        "fold_cloth3": "fold_cloth3",
        "fold_tshirt": "fold_tshirt",
        "unfold_cloth1": "unfold_cloth1",
        "unfold_cloth3": "unfold_cloth3",
        "whip_rope": "whip_rope",
        "shape_rope": "shape_rope",
        "shape_rope_hard": "shape_rope",
        "pour_water": "pour_water",
    }
    for task, ref_task in adopted.items():
        ours = np.load(os.path.join(asset_root, task, "goal.npy"))
        ref = np.load(os.path.join(ref_root, ref_task, "goal.npy"))
        np.testing.assert_array_equal(ours, ref, err_msg=task)


def test_tshirt_mask_matches_reference_contract():
    """The adopted t-shirt mask (scripts/adopt_assets.py: cv2-exact resize +
    rotate + threshold of the reference's t-shirt.jpg) must rasterize to
    exactly the particle count of the reference's recorded fold_tshirt goal
    cloud — the strongest available pin on mask fidelity
    (fold_cloth_tshirt_env.py:51-71)."""
    from unidom_tpu.envs.cloth_tasks import _tshirt_mask

    mask = np.asarray(_tshirt_mask(180))
    assert mask.shape == (180, 180)
    ref_goal = "/root/reference/DaXBench/daxbench/core/envs/goals/fold_tshirt/goal.npy"
    expected = np.load(ref_goal).shape[0] if os.path.exists(ref_goal) else 3573
    assert int(mask.sum()) == expected == 3573


def test_pour_soup_particle_construction_matches_reference():
    """pour_soup's particle set must follow the reference construction
    (pour_soup_env.py:121-160): water box (2877 = int(0.07^3*128^3*4)),
    two tofu boxes (343 = 7^3 grid points each at density 2 on the 128
    grid), and the adopted vegetable cloud (4131 voxel-downsampled points
    from model.pcd) - 7694 total."""
    from dataclasses import replace

    from unidom_tpu.envs.mpm_tasks import PourSoupConf, PourSoupEnv, _veg_point_cloud

    veg = _veg_point_cloud()
    assert veg.shape == (4131, 3)
    # cheap res so reset is fast; particle construction is res-independent
    conf = replace(PourSoupConf, res=(16, 8, 16), steps=2)
    env = PourSoupEnv(batch_size=1, conf=conf)
    env.reset(jax.random.PRNGKey(0))
    mats = np.asarray(env.simulator.material)
    assert (mats == 0).sum() == 2877  # water
    assert (mats == 1).sum() == 343 * 2 + 4131  # tofu + veg (elastic)
    assert env.simulator.n_particles == 7694


def test_whip_rope_obs_contract_vs_reference():
    """Pin the documented whip_rope obs deviation (615 vs the reference's
    612, docs/PARITY.md) with a recorded reference trajectory
    (scripts/record_whip_rope_obs.py). Layout mapping:

    - particle block obs[:402] (x, v flattened) is identical;
    - our primitive buffer has ``steps + 1`` rows where the reference has
      ``steps`` with its final FK write silently dropped
      (engine/primitives.py docstring): rows 1..steps-1 coincide, our row
      ``steps`` is the extra retained substep.

    whip_rope is position-controlled, so the collision field only reads
    rows 0..steps-1 — particle physics must agree to f32 tolerance for one
    macro step from the recorded reference state."""
    fix_path = os.path.join(os.path.dirname(__file__), "fixtures",
                            "whip_rope_ref_obs.npz")
    if not os.path.exists(fix_path):
        pytest.skip("whip_rope reference fixture not recorded")
    fix = np.load(fix_path)
    steps = int(fix["steps"])

    from unidom_tpu.envs.mpm_tasks import WhipRopeConf, WhipRopeEnv

    # the fixture may be recorded at a reduced substep count (the mapping
    # rule it pins is steps-independent; recording the reference at
    # steps=70 wedges its host-side trace — scripts/record_whip_rope_obs.py)
    conf = (None if steps == WhipRopeConf.steps
            else dataclasses.replace(WhipRopeConf, steps=steps))
    env = WhipRopeEnv(batch_size=2, seed=1, conf=conf)
    _, state = env.reset(jax.random.PRNGKey(1))
    P = env.simulator.n_particles
    assert env.observation_size == P * 6 + (steps + 1) * 3  # 615 for P=67
    assert fix["obs0"].shape[-1] == P * 6 + steps * 3  # reference 612

    # splice the recorded reference reset state into ours
    prim = state.primitives[0]
    pos = jnp.zeros_like(prim.position).at[:, :steps].set(fix["prim_pos0"])
    rot = jnp.zeros_like(prim.rotation).at[:, :steps].set(fix["prim_rot0"])
    state = state._replace(
        x=jnp.asarray(fix["x0"]), v=jnp.asarray(fix["v0"]),
        primitives=(prim._replace(position=pos, rotation=rot),),
    )

    obs = np.asarray(env.get_obs(state))
    np.testing.assert_allclose(obs[:, : P * 6], fix["obs0"][:, : P * 6],
                               atol=1e-6)

    _, reward, _, info = env.step_diff(jnp.asarray(fix["actions"][0]), state)
    obs1 = np.asarray(env.get_obs(info["state"]))
    ref1 = fix["obs1"]
    # particle block: exact physics parity for one macro step
    np.testing.assert_allclose(obs1[:, : P * 6], ref1[:, : P * 6],
                               rtol=1e-4, atol=1e-5)
    # primitive buffer rows 1..steps-1 coincide (shared FK writes)
    ours_rows = obs1[:, P * 6 :].reshape(2, steps + 1, 3)
    ref_rows = ref1[:, P * 6 :].reshape(2, steps, 3)
    np.testing.assert_allclose(ours_rows[:, 1:steps], ref_rows[:, 1:steps],
                               atol=1e-5)
    # the reference's copy_frame reads its dropped row via jnp clamp
    # semantics: its row 0 equals our row steps-1; our row 0 keeps the
    # full commanded motion (row steps)
    np.testing.assert_allclose(ref_rows[:, 0], ours_rows[:, steps - 1],
                               atol=1e-5)
    np.testing.assert_allclose(ours_rows[:, 0], ours_rows[:, steps],
                               atol=1e-6)
