"""Measure the reference-layout cloth baseline.

The reference cloth engine (DaXBench cloth_simulator.py:257-337) runs its
hot loop in a *packed + full-grid* layout: every substep scatters the packed
(P, 3) particle array onto a zeroed (N, N, 3) grid
(``.at[idx_i, idx_j].set``), then performs two (P*8, 3) gathers
(``x_grid[j_x, j_y]`` / ``x_grid[i_x, i_y]``) to form spring pairs — O(N^2)
memory traffic per substep to simulate P particles, plus a gather/scatter pair
XLA cannot fuse away. This script re-implements exactly that layout (not the
repo's dense-bbox static-shift engine) behind the same simulator
interface, runs it under the *identical* APG minimize harness and
configuration as bench.py on the same device, and prints the measured
steps/s/device as one JSON line.

This is the reference's own pure-JAX computation — the fairest available
"CUDA-JAX reference" stand-in, since the reference stack is pure jnp (no
CUDA kernels) and therefore portable verbatim.

Usage: python scripts/bench_baseline.py          (flags as bench.py)
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(msg):
    print(f"[baseline +{time.time() - T0:.1f}s] {msg}", file=sys.stderr, flush=True)


T0 = time.time()


def build_reference_layout_simulator():
    import jax
    import jax.numpy as jnp

    from unidom_tpu.engine.cloth import _LINKS, ClothSimulator, ClothState

    class ReferenceLayoutClothSimulator(ClothSimulator):
        """ClothSimulator with the reference's packed/full-grid hot loop.

        State stays dense (H, W, 3) at the robot-step boundary (the env
        contract); inside ``robot_step`` it is packed once, the 50 substeps
        run in the reference layout (cloth_simulator.py:257-337
        operator-for-operator), and the result is unpacked once — the
        conversions amortize to nothing over 50 substeps.
        """

        def _build_robot_step(self):
            conf = self.conf
            N = conf.N
            n_links = len(_LINKS)

            # reference topology precompute (cloth_simulator.py:48-66):
            # neighbor grid indices clipped to [0, N-1]; rest length from the
            # *clipped* offset (border springs shorten/zero out).
            idx_i = np.asarray(self.idx_i)
            idx_j = np.asarray(self.idx_j)
            grid_idx = np.stack([idx_i, idx_j], -1)  # (P, 2)
            j_ = grid_idx[:, None, :] + np.asarray(_LINKS)[None, :, :]
            j_ = np.clip(j_, 0, N - 1)
            i_ = np.broadcast_to(grid_idx[:, None, :], j_.shape)
            rest = conf.cell_size * np.linalg.norm(
                (j_ - i_).astype(np.float64), axis=-1
            )[..., None]
            ORI_NOT0 = jnp.asarray((rest != 0).astype(np.float32))
            REST = jnp.asarray(np.clip(rest, 1e-12, np.inf), jnp.float32)
            J_X = jnp.asarray(j_.reshape(-1, 2)[:, 0])
            J_Y = jnp.asarray(j_.reshape(-1, 2)[:, 1])
            I_X = jnp.asarray(i_.reshape(-1, 2)[:, 0])
            I_Y = jnp.asarray(i_.reshape(-1, 2)[:, 1])
            IDX_I = jnp.asarray(idx_i)
            IDX_J = jnp.asarray(idx_j)
            MASK_J = jnp.asarray(
                self.cloth_mask_np[j_[..., 0], j_[..., 1]].astype(np.float32)
            )[..., None]

            def primitive_collision(x, v, action, ps):
                pos, radius = ps[:3], ps[3]
                dist = jnp.linalg.norm(x - pos[None, :], axis=-1)
                mask = (dist <= radius)[:, None]
                v = jnp.where(mask, action[-1] * v, v)
                x = jnp.where(mask, x + action[:3] * (1.0 - action[-1]), x)
                return self._norm_grad(x), self._norm_grad(v)

            def substep_packed(x, v, state: ClothState):
                dt = conf.dt
                v = v - jnp.array([0.0, conf.gravity * dt, 0.0])

                # the reference layout: scatter packed -> full grid, two
                # (P*8, 3) gathers back out (cloth_simulator.py:261-263)
                x_grid = jnp.zeros((N, N, 3)).at[IDX_I, IDX_J].set(x)
                rel = x_grid[J_X, J_Y] - x_grid[I_X, I_Y]
                cur = jnp.clip((rel**2).sum(-1), 1e-12, jnp.inf) ** 0.5
                cur = cur.reshape(-1, n_links, 1)

                force = (
                    state.stiffness
                    * rel.reshape(-1, n_links, 3)
                    / cur
                    * (cur - REST)
                    / REST
                )
                force = force * ORI_NOT0 * MASK_J
                force = force.sum(1)
                force = force.at[:, 1].add(-conf.gravity)

                # ground friction (cloth_simulator.py:280-306)
                friction_mask = x[:, 1] <= conf.small_num
                muF = state.mu * jnp.clip(force[:, 1], -jnp.inf, 0.0) * -1.0
                xV, yV = v[:, 0], v[:, 2]
                sV = jnp.sqrt(xV**2 + yV**2 + conf.small_num)

                dyn = (friction_mask * (sV > conf.small_num)).astype(jnp.float32)
                force = force.at[:, 0].add(-dyn * muF * xV / sV)
                force = force.at[:, 2].add(-dyn * muF * yV / sV)

                stat = friction_mask * (sV <= conf.small_num)
                xF, yF = force[:, 0], force[:, 2]
                sF = jnp.sqrt(xF**2 + yF**2 + conf.small_num)

                zero = (stat * (muF > sF)).astype(jnp.float32)
                force = force.at[:, 0].set((1.0 - zero) * force[:, 0])
                force = force.at[:, 2].set((1.0 - zero) * force[:, 2])

                nz = (stat * (muF <= sF)).astype(jnp.float32)
                R = 1.0 - muF / sF
                force = force.at[:, 0].set((R * xF) * nz + force[:, 0] * (1.0 - nz))
                force = force.at[:, 2].set((R * yF) * nz + force[:, 2] * (1.0 - nz))

                v = v + force * dt
                v = v * jnp.exp(-conf.damping * dt)

                x, v = primitive_collision(x, v, state.action0, state.primitive0)
                x, v = primitive_collision(x, v, state.action1, state.primitive1)

                ps0 = state.primitive0.at[:3].add(state.action0[:3]).clip(0.0, 1.0)
                ps1 = state.primitive1.at[:3].add(state.action1[:3]).clip(0.0, 1.0)

                x = jnp.clip(x, 0.0, 1.0)
                v = jnp.clip(v, -conf.max_v, conf.max_v)
                x = x + dt * v

                x = self._norm_grad(x)
                v = self._norm_grad(v)
                ps0 = self._norm_grad(ps0)
                ps1 = self._norm_grad(ps1)
                return x, v, state._replace(primitive0=ps0, primitive1=ps1)

            def substep_scan(carry, _):
                x, v, state = carry
                return substep_packed(x, v, state), None

            # the reference wraps every substep in a recompute custom_vjp
            # (cloth_simulator.py:228-255) == jax.checkpoint per substep
            if conf.mem_saving_level >= 1:
                substep_scan = jax.checkpoint(substep_scan)

            def robot_step(state: ClothState, action):
                action0 = action.at[:3].set(action[:3].clip(-2, 2) / conf.n_substeps)[:4]
                action1 = action.at[4:7].set(action[4:7].clip(-2, 2) / conf.n_substeps)[4:8]
                key, _ = jax.random.split(state.key)
                state = state._replace(action0=action0, action1=action1, key=key)

                x_p = self.pack(state.x)
                v_p = self.pack(state.v)
                (x_p, v_p, state), _ = jax.lax.scan(
                    substep_scan, (x_p, v_p, state), None, length=conf.n_substeps
                )
                state = state._replace(
                    x=self.unpack(x_p, state.x), v=self.unpack(v_p, state.v)
                )
                return state, state

            if conf.mem_saving_level >= 2:
                robot_step = jax.checkpoint(robot_step)

            return robot_step

    return ReferenceLayoutClothSimulator


def main():
    from unidom_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax

    env_steps = int(os.environ.get("BENCH_EP_LEN", 3))
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 1024))
    iters = int(os.environ.get("BENCH_ITERS", 3))

    import unidom_tpu.envs.base_cloth as base_cloth
    from unidom_tpu.algorithms.apg import build_apg
    from unidom_tpu.engine.cloth import ClothConf
    from unidom_tpu.parallel.mesh import make_env_mesh

    base_cloth.ClothSimulator = build_reference_layout_simulator()
    from unidom_tpu.envs.cloth_tasks import FoldCloth3Env

    mesh = make_env_mesh()
    n_dev = mesh.devices.size
    num_envs = max(num_envs // n_dev, 1) * n_dev
    log(f"devices={n_dev} platform={jax.devices()[0].platform} num_envs={num_envs}")

    conf = ClothConf(
        N=80, stiffness=900.0, mem_saving_level=2, task="bench_fold_cloth3",
        goal_path="", use_substep_obs=False,
    )
    env = FoldCloth3Env(batch_size=num_envs // n_dev, conf=conf)
    log(f"reference-layout env constructed (P={env.n_particles})")

    init_ts, minimize, reset_batch, _ = build_apg(
        env, episode_length=env_steps, learning_rate=1e-4,
        max_gradient_norm=0.3, mesh=mesh,
    )
    ts = init_ts(0)
    state = reset_batch(jax.random.PRNGKey(0))
    jax.block_until_ready(state)

    log("compiling minimize (reference layout)")
    ts, metrics = minimize(ts, state)
    jax.block_until_ready(metrics)
    log(f"compile + first iter done ({time.time() - T0:.1f}s total)")

    t0 = time.time()
    for _ in range(iters):
        ts, metrics = minimize(ts, state)
    jax.block_until_ready(metrics)
    dt = (time.time() - t0) / iters
    sps = env_steps * num_envs / dt / n_dev
    log(f"{iters} timed iters, {dt:.3f}s/iter -> {sps:.2f} steps/s/device")

    record = {
        "sps_fold_cloth3_reference_layout": round(sps, 2),
        "baseline_config": {
            "num_envs": num_envs, "ep_len": env_steps, "devices": n_dev,
            "platform": jax.devices()[0].platform,
            "iter_walltime_s": round(dt, 3),
            "layout": "packed + full-grid scatter/gather per substep "
                      "(cloth_simulator.py:257-337), per-substep recompute vjp",
        },
    }
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
