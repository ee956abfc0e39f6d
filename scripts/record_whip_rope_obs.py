"""Record reference whip_rope observations through the shim (round-3
verdict item 6): pin the documented 612 -> 615 obs-layout mapping with a
golden fixture, the way fold_cloth1's obs contract is pinned by recorded
demos (tests/test_golden.py).

Protocol: reset the reference WhipRopeEnv (batch 2, seed 1), record
(obs0, x0, v0, prim0 buffer), apply two fixed macro actions via its own
step_diff, recording obs/x after each. tests/test_golden.py replays the
same actions from the recorded initial state on our env and checks the
particle block exactly plus the primitive-buffer mapping (our steps+1
buffer vs the reference's steps buffer with its silently-dropped last FK
write — engine/primitives.py docstring).

Runs on JAX's default device. Prefer a GPU: the reference engine's XLA-CPU
compile of its 27x-materialized scatter substep is pathological (over 15
minutes and most of the host's RAM).

    python scripts/record_whip_rope_obs.py
"""

import os
import sys

import jax
import numpy as np

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _here)

import reference_baseline_run as shim  # noqa: E402  (module-level stubs + imports)
import jax.numpy as jnp  # noqa: E402

shim.apply_mpm_patches()  # whip_rope is an MPM env (render no-op, float0 fixes)


def main():
    conf = None
    steps_override = int(os.environ.get("WHIP_STEPS", 0))
    if steps_override:
        # Reduced-substep recording: the host-side trace of the reference
        # engine's 27x-materialized scatter substep at steps=70 wedges
        # nondeterministically (>100 GB RSS, runs/r4/record_whip_obs*.log
        # — two bounded attempts). The 612 <-> 615 obs-layout mapping the
        # fixture pins (particle blocks + prim-buffer off-by-one) is
        # steps-independent, so record at a small steps count; the golden
        # test reads `steps` from the fixture and sizes both envs from it.
        from daxbench.core.envs.whip_rope_env import DefaultConf

        conf = DefaultConf()
        conf.steps = steps_override
    env = shim.ENVS["whip_rope"](batch_size=2, seed=1, conf=conf)
    obs, state = env.reset(jax.random.PRNGKey(1))
    rec = {
        "obs0": np.asarray(obs),
        "x0": np.asarray(state.x),
        "v0": np.asarray(state.v),
        "prim_pos0": np.asarray(state.primitives[0].position),
        "prim_rot0": np.asarray(state.primitives[0].rotation),
        "steps": np.asarray(env.conf.steps),
    }
    actions = np.array(
        [[[0.3, 0.0, 0.5, 0.0, 0.0, 0.0], [0.3, 0.0, 0.5, 0.0, 0.0, 0.0]],
         [[-0.2, 0.1, 0.4, 0.0, 0.0, 0.0], [-0.2, 0.1, 0.4, 0.0, 0.0, 0.0]]],
        np.float32,
    )  # (2 steps, 2 envs, 6)
    rec["actions"] = actions
    for t in range(2):
        obs, reward, done, info = env.step_diff(jnp.asarray(actions[t]), state)
        state = info["state"]
        rec[f"obs{t + 1}"] = np.asarray(obs)
        rec[f"x{t + 1}"] = np.asarray(state.x)
        rec[f"reward{t + 1}"] = np.asarray(reward)
    out = os.path.join(_here, "..", "tests", "fixtures", "whip_rope_ref_obs.npz")
    np.savez_compressed(out, **rec)
    print(f"saved {out}: obs {rec['obs0'].shape}, P = {rec['x0'].shape}")


if __name__ == "__main__":
    main()
