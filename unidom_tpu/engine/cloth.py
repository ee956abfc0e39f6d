"""Differentiable mass-spring cloth simulator in plain JAX, compiled by XLA.

Semantics match the reference engine
(DaXBench/daxbench/core/engine/cloth_simulator.py:13-373): an N x N grid of
particles restricted to an arbitrary ``cloth_mask``, 8-neighbor springs,
gravity, damping, static+dynamic ground friction, two suction-ball grippers,
50 substeps per robot step, per-substep gradient renormalization.

Design deltas from the reference (deliberate, documented):

- **Dense bounding-box layout with static shifts instead of gathers.** The
  reference scatters packed particles onto an (N, N) grid every substep and
  gathers spring endpoints through index arrays
  (cloth_simulator.py:261-262); a packed layout still needs a (P, 8) gather
  per substep. Here the state lives densely on the mask's bounding box
  (H, W, 3) and each of the 8 spring neighbors is a *static pad+slice* — no
  gather/scatter anywhere in the hot loop, so XLA fuses each substep into a
  handful of elementwise kernels.
  Cells outside the mask carry inert particles whose force contributions are
  masked out exactly like the reference masks non-cloth grid cells; packed
  views for observations/rewards are one cheap gather per macro step.
- **``jax.checkpoint`` rematerialization instead of hand-rolled
  recompute-VJPs** (cloth_simulator.py:107-161, 228-255), with the same
  ``mem_saving_level`` 0/1/2 semantics.
- **Material parameters are traced state** (``stiffness``, ``mu`` live in
  ``ClothState``), so parameter-randomized (GenORM-style "para") training
  never re-traces.
- Everything is a pure function of (state, action); batching is one outer
  ``vmap`` sized to fill a device, multi-device via ``shard_map`` upstream.
"""

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from unidom_tpu.ops.gradops import normalize_grad


class ClothState(NamedTuple):
    """Per-env dynamic state. ``x``/``v`` are dense over the mask's bounding
    box (H, W, 3); use ``ClothSimulator.pack`` for the packed (P, 3) view."""

    x: jnp.ndarray  # (H, W, 3) particle positions (dense bbox layout)
    v: jnp.ndarray  # (H, W, 3) particle velocities
    primitive0: jnp.ndarray  # (4,) gripper-0 [x, y, z, radius]
    primitive1: jnp.ndarray  # (4,) gripper-1
    action0: jnp.ndarray  # (4,) per-substep gripper-0 action [dx, dy, dz, suction]
    action1: jnp.ndarray  # (4,)
    key: jnp.ndarray  # PRNG key
    cur_step: jnp.ndarray  # () int32 macro-step counter
    stiffness: jnp.ndarray  # () spring stiffness — traced material parameter
    mu: jnp.ndarray  # () ground friction coefficient — traced


@dataclass
class ClothConf:
    """Static cloth configuration (baked into the jit trace).

    Mirrors the per-env DefaultConf dataclasses
    (e.g. fold_cloth1_env.py:15-33). ``stiffness``/``mu`` here are only the
    reset-time defaults; the live values are traced state.
    """

    N: int = 80
    gravity: float = 0.5
    stiffness: float = 900.0
    damping: float = 2.0
    dt: float = 2e-3
    max_v: float = 2.0
    small_num: float = 1e-8
    mu: float = 0.5
    seed: int = 1
    mem_saving_level: int = 2  # 0: no remat, 1: remat substeps, 2: remat substeps + robot step
    n_substeps: int = 50
    gripper_radius: float = 0.01  # suction-ball radius (must exceed half the
    # particle spacing 1/N for the gripper to capture cloth)
    task: str = "cloth"
    goal_path: str = ""
    use_substep_obs: bool = True

    @property
    def cell_size(self):
        return 1.0 / self.N

    @property
    def size(self):
        return int(self.N / 5.0)


# 8-connected spring topology
_LINKS = np.array(
    [[-1, 0], [1, 0], [0, -1], [0, 1], [-1, -1], [1, -1], [-1, 1], [1, 1]]
)


class ClothSimulator:
    """Owns the precomputed spring topology and the pure step/reset functions.

    ``step`` maps ``(state, action(8,)) -> (state, state)`` for a single env;
    ``step_batch`` is the vmapped version used by envs.
    """

    def __init__(self, conf: ClothConf, batch_size: int, collision_func, cloth_mask):
        assert batch_size >= 1
        self.conf = conf
        self.batch_size = batch_size
        self.collision_func = collision_func

        N = conf.N
        # Topology is built on the host from a numpy mask; jnp copies are
        # made once, host->device.
        mask = np.asarray(cloth_mask) if not isinstance(cloth_mask, np.ndarray) else cloth_mask
        self.cloth_mask_np = mask
        self.cloth_mask = jnp.asarray(mask)

        idx_i, idx_j = np.nonzero(mask)
        assert len(idx_i) > 0, "empty cloth mask"
        self.idx_i = jnp.asarray(idx_i)
        self.idx_j = jnp.asarray(idx_j)
        self.n_particles = int(len(idx_i))

        # bounding box of the mask on the N-grid
        i0, i1 = int(idx_i.min()), int(idx_i.max()) + 1
        j0, j1 = int(idx_j.min()), int(idx_j.max()) + 1
        self.bbox = (i0, i1, j0, j1)
        self.H, self.W = i1 - i0, j1 - j0

        # packed <-> dense mapping (for obs / reward / render)
        mask_bbox = mask[i0:i1, j0:j1]
        self.mask_bbox = jnp.asarray(mask_bbox.astype(np.float32))
        flat_idx = np.flatnonzero(mask_bbox.reshape(-1) > 0)
        self.pack_idx = jnp.asarray(flat_idx)

        # per-cell, per-link rest length and validity from the reference's
        # global-grid clip rule (cloth_simulator.py:56-63): neighbor index is
        # clipped to [0, N-1]; rest length can shorten/zero at the border.
        gi, gj = np.meshgrid(np.arange(i0, i1), np.arange(j0, j1), indexing="ij")
        cell = np.stack([gi, gj], axis=-1)  # (H, W, 2) global indices
        nbr = cell[:, :, None, :] + _LINKS[None, None, :, :]
        nbr_clipped = np.clip(nbr, 0, N - 1)
        rest = conf.cell_size * np.linalg.norm(nbr_clipped - cell[:, :, None, :], axis=-1)
        valid = (rest != 0.0).astype(np.float32)
        valid *= mask[nbr_clipped[..., 0], nbr_clipped[..., 1]].astype(np.float32)
        valid *= mask_bbox[..., None].astype(np.float32)  # sources outside mask are inert
        self.rest_len_np = np.clip(rest, 1e-12, np.inf).astype(np.float32)[..., None]
        self.nbr_valid_np = valid[..., None].astype(np.float32)  # (H, W, 8, 1)
        self.rest_len = jnp.asarray(self.rest_len_np)
        self.nbr_valid = jnp.asarray(self.nbr_valid_np)

        self.indices = self._build_triangles(mask)
        self.key_global = jax.random.PRNGKey(conf.seed)
        self._norm_grad = normalize_grad(scale=float(mask.sum()))

        self.step = self._build_robot_step()
        self.step_batch = jax.vmap(self.step)
        self.x_grid_init = None  # filled by reset

    # ------------------------------------------------------------------ #
    # layout helpers
    # ------------------------------------------------------------------ #

    def pack(self, x_dense):
        """Dense (..., H, W, 3) -> packed (..., P, 3) over mask cells."""
        flat = x_dense.reshape(x_dense.shape[:-3] + (self.H * self.W, 3))
        return jnp.take(flat, self.pack_idx, axis=-2)

    def unpack(self, x_packed, fill):
        """Packed (P, 3) -> dense (H, W, 3), non-mask cells from ``fill``."""
        flat = fill.reshape(self.H * self.W, 3)
        flat = flat.at[self.pack_idx].set(x_packed)
        return flat.reshape(self.H, self.W, 3)

    def _build_triangles(self, mask):
        """Triangle index list for mesh rendering (semantics of
        cloth_simulator.py:72-103: two triangles per fully-masked 3x3
        neighborhood square); indices address the N x N grid."""
        N = self.conf.N
        tris = []
        for i in range(1, N - 1):
            for j in range(1, N - 1):
                window = mask[i - 1 : i + 2, j - 1 : j + 2]
                if window.shape != (3, 3) or not np.all(window > 0):
                    continue
                tris.append([i * N + j, (i + 1) * N + j, i * N + (j + 1)])
                tris.append([(i + 1) * N + j + 1, i * N + (j + 1), (i + 1) * N + j])
        if not tris:
            return jnp.zeros((0, 3), dtype=jnp.int32)
        return jnp.asarray(np.array(tris, dtype=np.int32))

    def get_x_grid(self, x_batch):
        """Embed the dense bbox back onto the full (N, N, 3) grid."""
        i0, i1, j0, j1 = self.bbox

        def one(x):
            vals = jnp.where(self.mask_bbox[..., None] > 0, x, self.x_grid_init[i0:i1, j0:j1])
            return self.x_grid_init.at[i0:i1, j0:j1].set(vals)

        return jax.vmap(one)(x_batch)

    # ------------------------------------------------------------------ #
    # dynamics
    # ------------------------------------------------------------------ #

    @staticmethod
    def _shift(xp, di, dj, H, W):
        """Neighbor view of the edge-padded array: static slice, no gather."""
        return jax.lax.slice(
            xp, (1 + di, 1 + dj, 0), (1 + di + H, 1 + dj + W, xp.shape[-1])
        )

    def _spring_force(self, x, stiffness):
        """Sum of the 8 masked spring forces. x: (H, W, 3) -> (H, W, 3)."""
        H, W = self.H, self.W
        xp = jnp.pad(x, ((1, 1), (1, 1), (0, 0)), mode="edge")
        force = jnp.zeros_like(x)
        for l, (di, dj) in enumerate(_LINKS):
            nb = self._shift(xp, int(di), int(dj), H, W)
            rel = nb - x
            cur = jnp.clip(jnp.sum(rel * rel, -1, keepdims=True), 1e-12, jnp.inf) ** 0.5
            rest = self.rest_len[:, :, l]
            fl = stiffness * rel / cur * (cur - rest) / rest
            force = force + fl * self.nbr_valid[:, :, l]
        return force

    def _primitive_collision(self, x, v, action, ps):
        """Suction-ball gripper (cloth_simulator.py:198-226): particles inside
        the ball move rigidly with it while suction is engaged."""
        pos, radius = ps[:3], ps[3]
        d_v = action[:3]
        suction = action[-1]

        dist = jnp.linalg.norm(x - pos[None, None, :], axis=-1)
        mask = (dist <= radius)[..., None]
        v = jnp.where(mask, suction * v, v)
        x = jnp.where(mask, x + d_v * (1.0 - suction), x)

        x = self._norm_grad(x)
        v = self._norm_grad(v)
        return x, v

    def _substep(self, state: ClothState):
        conf = self.conf
        dt = conf.dt
        x, v = state.x, state.v

        v = v - jnp.array([0.0, conf.gravity * dt, 0.0])

        force = self._spring_force(x, state.stiffness)
        force = force.at[..., 1].add(-conf.gravity)

        # ground friction (cloth_simulator.py:280-306)
        friction_mask = x[..., 1] <= conf.small_num
        muF = state.mu * jnp.clip(force[..., 1], -jnp.inf, 0.0) * -1.0
        xV, yV = v[..., 0], v[..., 2]
        sV = jnp.sqrt(xV**2 + yV**2 + conf.small_num)

        dyn = (friction_mask * (sV > conf.small_num)).astype(jnp.float32)
        force = force.at[..., 0].add(-dyn * muF * xV / sV)
        force = force.at[..., 2].add(-dyn * muF * yV / sV)

        stat = friction_mask * (sV <= conf.small_num)
        xF, yF = force[..., 0], force[..., 2]
        sF = jnp.sqrt(xF**2 + yF**2 + conf.small_num)

        zero = (stat * (muF > sF)).astype(jnp.float32)
        force = force.at[..., 0].set((1.0 - zero) * force[..., 0])
        force = force.at[..., 2].set((1.0 - zero) * force[..., 2])

        nonzero = (stat * (muF <= sF)).astype(jnp.float32)
        R = 1.0 - muF / sF
        force = force.at[..., 0].set((R * xF) * nonzero + force[..., 0] * (1.0 - nonzero))
        force = force.at[..., 2].set((R * yF) * nonzero + force[..., 2] * (1.0 - nonzero))

        v = v + force * dt
        v = v * jnp.exp(-conf.damping * dt)

        # collisions
        v = self.collision_func(x, v, self.idx_i, self.idx_j)
        x, v = self._primitive_collision(x, v, state.action0, state.primitive0)
        x, v = self._primitive_collision(x, v, state.action1, state.primitive1)

        ps0 = state.primitive0.at[:3].add(state.action0[:3]).clip(0.0, 1.0)
        ps1 = state.primitive1.at[:3].add(state.action1[:3]).clip(0.0, 1.0)

        x = jnp.clip(x, 0.0, 1.0)
        v = jnp.clip(v, -conf.max_v, conf.max_v)
        x = x + dt * v

        x = self._norm_grad(x)
        v = self._norm_grad(v)
        ps0 = self._norm_grad(ps0)
        ps1 = self._norm_grad(ps1)

        return state._replace(x=x, v=v, primitive0=ps0, primitive1=ps1)

    def _build_robot_step(self):
        conf = self.conf

        def substep_scan(state, _):
            return self._substep(state), None

        if conf.mem_saving_level >= 1:
            substep_scan = jax.checkpoint(substep_scan)

        def robot_step(state: ClothState, action):
            # per-substep velocity normalization (50 substeps, /50 scale,
            # cloth_simulator.py:167-169)
            action0 = action.at[:3].set(action[:3].clip(-2, 2) / conf.n_substeps)[:4]
            action1 = action.at[4:7].set(action[4:7].clip(-2, 2) / conf.n_substeps)[4:8]

            key, _ = jax.random.split(state.key)
            state = state._replace(action0=action0, action1=action1, key=key)

            state, _ = jax.lax.scan(substep_scan, state, None, length=conf.n_substeps)
            return state, state

        if conf.mem_saving_level >= 2:
            robot_step = jax.checkpoint(robot_step)

        return robot_step

    # ------------------------------------------------------------------ #
    # reset
    # ------------------------------------------------------------------ #

    def reset(self):
        """Build the batched initial state (flat cloth at rest)."""
        conf = self.conf
        N = conf.N
        ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
        grid = np.stack(
            [ii * conf.cell_size, np.zeros_like(ii, dtype=np.float64), (N - jj) * conf.cell_size],
            axis=-1,
        ).astype(np.float32)
        self.x_grid_init = jnp.asarray(grid)

        i0, i1, j0, j1 = self.bbox
        x = self.x_grid_init[i0:i1, j0:j1]
        v = jnp.zeros((self.H, self.W, 3), dtype=jnp.float32)
        r = conf.gripper_radius
        ps0 = jnp.array([0.5, 0.5, 0.5, r], dtype=jnp.float32)
        ps1 = jnp.array([1.0, 1.0, 1.0, r], dtype=jnp.float32)

        key, _ = jax.random.split(self.key_global)
        state = ClothState(
            x=x,
            v=v,
            primitive0=ps0,
            primitive1=ps1,
            action0=jnp.zeros(4, dtype=jnp.float32),
            action1=jnp.zeros(4, dtype=jnp.float32),
            key=key,
            cur_step=jnp.array(0, dtype=jnp.int32),
            stiffness=jnp.asarray(conf.stiffness, dtype=jnp.float32),
            mu=jnp.asarray(conf.mu, dtype=jnp.float32),
        )
        state = jax.tree_util.tree_map(
            lambda t: jnp.broadcast_to(t[None, ...], (self.batch_size,) + t.shape), state
        )
        return state
