"""Differentiable 3-D MLS-MPM simulator in plain JAX, compiled by XLA.

One engine covering the reference's two MPM implementations:
- the JAX engine's materials water(0) / elastic(1) / sigma-clip plastic(2)
  (DaXBench/daxbench/core/engine/mpm_simulator.py:223-330), and
- the Taichi fork's von-Mises plasticity(3) with runtime-settable
  E / nu / yield_stress (GenORM/policy/pbm/plb/engine/mpm_simulator.py:134-150,
  479-485) — here the Lame parameters and yield stress are *traced state*
  (scalar or per-particle), so parameter randomization / identification
  never re-traces or re-forks the engine.

Design deltas from the reference:
- **Flat-index scatter/gather P2G/G2P.** The reference materializes
  27x-repeated (27, P, ...) tensors and scatters through 3-D advanced
  indexing (mpm_simulator.py:178-221, 270-274, 318-324). We compute the
  quadratic B-spline weights as a (P, 27) outer product and do a single
  1-D segment scatter-add / gather over the flattened grid — O(27 P)
  memory traffic with no index-tuple materialization.
- **Out-of-range particles are masked explicitly** (weight zeroed, index
  clamped) rather than relying on silent out-of-bounds scatter drops.
- **``jax.checkpoint`` over a ``lax.scan`` of substeps** replaces the
  per-substep recompute custom-VJP machinery (mpm_simulator.py:332-363):
  same memory behavior (only the substep boundary state is saved), same
  gradient, less machinery. The per-substep cotangent norm clamp
  (``norm_grad``/``norm_grad_state``) is preserved verbatim.
- Primitive substep buffers are ``steps + 1`` long (see
  engine/primitives.py docstring for the off-by-one this fixes).
"""

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from unidom_tpu.engine.primitives import (
    PrimitiveState,
    forward_kinematics,
    make_collider,
    set_action,
)
from unidom_tpu.ops.gradops import clamp_grad_norm_tree, scrub_mpm_state
from unidom_tpu.ops.svd3 import svd3

# material enum
WATER, ELASTIC, PLASTIC_CLIP, VON_MISES = 0, 1, 2, 3


class MPMState(NamedTuple):
    """Dynamic MPM state for one env (batch via vmap)."""

    x: jnp.ndarray  # (P, 3) positions
    v: jnp.ndarray  # (P, 3) velocities
    C: jnp.ndarray  # (P, 3, 3) affine velocity (APIC)
    F: jnp.ndarray  # (P, 3, 3) deformation gradient
    J: jnp.ndarray  # (P,) volume ratio
    cur_step: jnp.ndarray  # () int32
    primitives: Tuple[PrimitiveState, ...]
    key: jnp.ndarray
    friction: jnp.ndarray  # (1,) ground friction — traced
    mu: jnp.ndarray  # (1,) or (P,) Lame mu — traced material parameter
    lamda: jnp.ndarray  # (1,) or (P,) Lame lambda — traced
    yield_stress: jnp.ndarray  # (1,) or (P,) von-Mises yield — traced


@dataclass
class MPMConf:
    """Static MPM configuration (baked into the trace). Mirrors the per-env
    DefaultConf dataclasses (e.g. whip_rope_env.py:27-74)."""

    n_grid: int = 64
    dt: float = 1e-4
    steps: int = 70  # substeps per macro action
    E: float = 100.0
    nu: float = 0.1
    yield_stress: float = 50.0
    ground_friction: float = 0.1
    res: Tuple[int, int, int] = (32, 32, 32)
    gravity: Tuple[float, float, float] = (0.0, -9.8, 0.0)
    n_primitive: int = 1
    primitive_action_steps: int = 1
    seed: int = 0
    task: str = "mpm"
    goal_path: str = ""
    transfer: str = "auto"  # "auto" | "scatter" | "dense": particle<->grid
    # transfer scheme. "dense" is the separable tensor-product form (three
    # per-axis B-spline basis matrices contracted as batched matmuls, no
    # scatter/gather); "scatter" is the flat-index segment scatter. "auto"
    # picks dense when the intermediate (P x plane) tensors fit comfortably.

    @property
    def dx(self):
        return 1.0 / self.n_grid

    @property
    def inv_dx(self):
        return float(self.n_grid)

    @property
    def p_vol(self):
        return (self.dx * 0.5) ** 2

    @property
    def p_mass(self):
        return self.p_vol * 1.0  # p_rho = 1


_OFFSETS = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)])


class MPMSimulator:
    """Owns static particle attributes (material, hardness) and the pure
    step/reset functions. ``step`` maps (state, action(6 n_prim,)) ->
    (state, state) for one env; ``step_batch`` is the vmapped version."""

    def __init__(self, conf: MPMConf, batch_size: int, use_position_control=False):
        self.conf = conf
        self.batch_size = batch_size
        self.use_position_control = use_position_control
        self.key_global = jax.random.PRNGKey(conf.seed)

        self.n_particles = 0
        self.material = None  # (P,) np int — static per env instance
        self.h = None  # (P,) np float hardness

        self.sdf_names = []  # one per primitive, static
        self._colliders = []  # (collide, position_control) per primitive

        res = conf.res
        a, b, c = np.indices(res)
        self.grid_idx = jnp.asarray(
            np.stack([a, b, c], axis=-1).reshape(-1, 3), dtype=jnp.int32
        )
        self.grid_idx_3d = self.grid_idx.reshape(res + (3,))
        self.offsets = jnp.asarray(_OFFSETS, dtype=jnp.int32)  # (27, 3)

        self.step = None  # built by finalize()
        self.step_batch = None

    # ------------------------------------------------------------------ #
    # scene construction (host-side, before jit)
    # ------------------------------------------------------------------ #

    def register_primitive_sdf(self, sdf_name):
        self.sdf_names.append(sdf_name)
        self._colliders.append(make_collider(sdf_name))

    def add_box(self, state, size, init_pos, hardness=1.0, z_rotation_angle=0.0,
                material=WATER, density=1.0, key=None):
        """Sample particles for a box region (mpm_simulator.py:65-125):
        uniform-random fill for water, regular grid fill for solids."""
        conf = self.conf
        size = np.asarray(size, np.float64)
        init_pos = np.asarray(init_pos, np.float64)
        rot = np.array(
            [
                [np.cos(z_rotation_angle), -np.sin(z_rotation_angle)],
                [np.sin(z_rotation_angle), np.cos(z_rotation_angle)],
            ]
        )

        if material == WATER:
            n_points = int(size.prod() * conf.n_grid**3 * density)
            key = self.key_global if key is None else key
            x_ = np.asarray(jax.random.uniform(key, (n_points, 3)))
            x_ = (x_ * 2 - 1) * (0.5 * size)
            x_[:, [0, 2]] = x_[:, [0, 2]] @ rot.T
            x_ = x_ + init_pos
        else:
            n_grid = int(conf.n_grid * density)
            center = np.array([0.5, 0.01, 0.5])
            lower = -0.5 * size + center
            upper = 0.5 * size + center
            coords = np.stack(np.indices((n_grid,) * 3), axis=-1) / n_grid
            mask = np.all((coords <= upper) & (coords >= lower), axis=-1)
            x_ = coords[mask] - center
            x_[:, [0, 2]] = x_[:, [0, 2]] @ rot.T
            x_ = x_ + init_pos

        return self._append_particles(state, x_.astype(np.float32), material, hardness)

    def add_sphere(self, state, radius, init_pos, hardness=1.0, material=WATER,
                   density=1.0):
        """Regular-grid sphere particle sampler (the plb shape_maker 'sphere'
        capability, shapes/shape_maker.py:12-80)."""
        conf = self.conf
        n_grid = int(conf.n_grid * density)
        coords = np.stack(np.indices((n_grid,) * 3), axis=-1) / n_grid - 0.5
        mask = (coords**2).sum(-1) <= radius * radius
        x_ = coords[mask] + np.asarray(init_pos, np.float64)
        return self._append_particles(state, x_.astype(np.float32), material, hardness)

    def add_points(self, state, points, hardness=1.0, material=WATER):
        return self._append_particles(state, np.asarray(points, np.float32), material, hardness)

    def _append_particles(self, state, x_, material, hardness):
        n = x_.shape[0]
        mat = np.full((n,), material, dtype=np.int32)
        h = np.full((n,), hardness, dtype=np.float32)
        if state is None:
            self.material, self.h = mat, h
        else:
            x_ = np.concatenate([np.asarray(state.x), x_], axis=0)
            self.material = np.concatenate([self.material, mat])
            self.h = np.concatenate([self.h, h])
        return MPMState(
            x=jnp.asarray(x_), v=None, C=None, F=None, J=None, cur_step=None,
            primitives=[], key=None, friction=None, mu=None, lamda=None,
            yield_stress=None,
        )

    def finalize(self):
        """Freeze particle count/materials and build the jittable functions."""
        self.n_particles = len(self.material)
        self._material = jnp.asarray(self.material)
        self._h = jnp.asarray(self.h)
        self.transfer_mode = self._pick_transfer()
        self.step = self._build_step()
        self.step_batch = jax.vmap(self.step)

    def _pick_transfer(self):
        conf = self.conf
        if conf.transfer != "auto":
            return conf.transfer
        rx, ry, rz = conf.res
        # largest dense intermediate is (P, plane, 3); keep it under ~32 MB
        plane = max(rx * ry, ry * rz, rx * rz)
        return "dense" if self.n_particles * plane * 3 * 4 <= 32 * 2**20 else "scatter"

    # ------------------------------------------------------------------ #
    # reset
    # ------------------------------------------------------------------ #

    def reset(self, state: MPMState):
        conf = self.conf
        self.finalize()
        P = self.n_particles
        E, nu = conf.E, conf.nu
        mu_0, lambda_0 = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))

        state = state._replace(
            v=jnp.zeros((P, 3), jnp.float32),
            C=jnp.zeros((P, 3, 3), jnp.float32),
            F=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (P, 3, 3)),
            J=jnp.ones((P,), jnp.float32),
            cur_step=jnp.array(0, jnp.int32),
            key=self.key_global,
            friction=jnp.array([conf.ground_friction], jnp.float32),
            mu=jnp.array([mu_0], jnp.float32),
            lamda=jnp.array([lambda_0], jnp.float32),
            yield_stress=jnp.array([conf.yield_stress], jnp.float32),
            primitives=tuple(state.primitives),
        )
        state = jax.tree_util.tree_map(
            lambda t: jnp.broadcast_to(t[None, ...], (self.batch_size,) + t.shape), state
        )
        key = jax.random.split(self.key_global, self.batch_size)
        return state._replace(key=key)

    # ------------------------------------------------------------------ #
    # core dynamics (single env; vmapped)
    # ------------------------------------------------------------------ #

    def _weights_and_indices(self, x):
        """Quadratic B-spline stencil: per-particle 27 weights + flat grid
        indices + validity mask."""
        conf = self.conf
        res = conf.res
        base = jnp.floor(x * conf.inv_dx - 0.5).astype(jnp.int32)  # (P, 3)
        fx = x * conf.inv_dx - base.astype(jnp.float32)  # (P, 3)

        # w[:, a, d]: weight of stencil node a (0..2) along dim d
        w = jnp.stack(
            [0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2],
            axis=1,
        )  # (P, 3, 3)
        weight = (
            w[:, :, 0][:, :, None, None]
            * w[:, :, 1][:, None, :, None]
            * w[:, :, 2][:, None, None, :]
        ).reshape(-1, 27)  # (P, 27)

        node = base[:, None, :] + self.offsets[None, :, :]  # (P, 27, 3)
        in_bounds = jnp.all((node >= 0) & (node < jnp.array(res)), axis=-1)  # (P, 27)
        weight = jnp.where(in_bounds, weight, 0.0)
        node = jnp.clip(node, 0, jnp.array(res) - 1)
        flat = (node[..., 0] * res[1] + node[..., 1]) * res[2] + node[..., 2]  # (P, 27)

        dpos_units = self.offsets[None, :, :].astype(jnp.float32) - fx[:, None, :]  # (P, 27, 3)
        return weight, flat, dpos_units

    # ------------------------------------------------------------------ #
    # dense (separable tensor-product) particle<->grid transfers
    # ------------------------------------------------------------------ #

    def _axis_basis(self, xd, R):
        """Per-axis quadratic B-spline basis. xd: (P,) coordinate * inv_dx.
        Returns (w, wd): (P, R) with w[p, i] the weight of grid node i and
        wd[p, i] = w * (i - xd) (the dpos-weighted basis used for the affine
        momentum and C reconstruction). Out-of-range nodes are naturally
        absent — identical semantics to the masked scatter path."""
        t = jnp.arange(R, dtype=jnp.float32)[None, :] - xd[:, None]
        at = jnp.abs(t)
        w = jnp.where(
            at < 0.5, 0.75 - t * t,
            jnp.where(at < 1.5, 0.5 * (1.5 - at) ** 2, 0.0),
        )
        return w, w * t

    def _bases(self, x):
        conf = self.conf
        rx, ry, rz = conf.res
        wx, wxd = self._axis_basis(x[:, 0] * conf.inv_dx, rx)
        wy, wyd = self._axis_basis(x[:, 1] * conf.inv_dx, ry)
        wz, wzd = self._axis_basis(x[:, 2] * conf.inv_dx, rz)
        return (wx, wxd), (wy, wyd), (wz, wzd)

    def _p2g_dense(self, x, v, affine):
        """grid_v (res, 3), grid_m (res) by three-axis tensor contraction:
        grid = T(wx, wy, wz; m v) + dx [T(wxd, wy, wz; A col0) + ...]."""
        conf = self.conf
        rx, ry, rz = conf.res
        P = x.shape[0]
        (wx, wxd), (wy, wyd), (wz, wzd) = self._bases(x)

        def chain(a, b, c, val):
            # out[i, j, k, ch] = sum_p a[p,i] b[p,j] c[p,k] val[p,ch]
            byc = jnp.einsum("pj,pk->pjk", b, c).reshape(P, ry * rz)
            outs = [
                (a * val[:, ch : ch + 1]).T @ byc for ch in range(val.shape[1])
            ]
            return jnp.stack(outs, -1).reshape(rx, ry, rz, val.shape[1])

        # grid momentum = sum_p w (p_mass v + A @ dpos), dpos = (node - x/dx)*dx;
        # the A term separates into the dpos-weighted basis per axis
        grid_v = chain(wx, wy, wz, conf.p_mass * v)
        grid_v += conf.dx * chain(wxd, wy, wz, affine[:, :, 0])
        grid_v += conf.dx * chain(wx, wyd, wz, affine[:, :, 1])
        grid_v += conf.dx * chain(wx, wy, wzd, affine[:, :, 2])
        grid_m = chain(wx, wy, wz, jnp.full((P, 1), conf.p_mass))[..., 0]
        return grid_v, grid_m

    def _g2p_dense(self, x, grid_v):
        """new_v (P, 3) and new_C (P, 3, 3) by the adjoint contractions."""
        conf = self.conf
        rx, ry, rz = conf.res
        (wx, wxd), (wy, wyd), (wz, wzd) = self._bases(x)
        g = grid_v.reshape(rx, ry, rz, 3)

        def chain(a, b, c):
            t = jnp.einsum("pj,ijkc->pikc", b, g)  # contract y
            t = jnp.einsum("pk,pikc->pic", c, t)  # contract z
            return jnp.einsum("pi,pic->pc", a, t)  # contract x

        new_v = chain(wx, wy, wz)
        C0 = chain(wxd, wy, wz)
        C1 = chain(wx, wyd, wz)
        C2 = chain(wx, wy, wzd)
        # note dpos here is (node - x*inv_dx), unscaled — reference g2p
        # convention (mpm_simulator.py:200-201); wd already carries it
        new_C = 4.0 * conf.inv_dx * jnp.stack([C0, C1, C2], axis=-1)
        return new_v, new_C

    def _p2g(self, x, v, affine):
        """Particle-to-grid: grid momentum (res + (3,)) and mass (res)."""
        if self.transfer_mode == "dense":
            return self._p2g_dense(x, v, affine)
        conf = self.conf
        res = conf.res
        n_cells = res[0] * res[1] * res[2]
        weight, flat, dpos_units = self._weights_and_indices(x)
        dpos = dpos_units * conf.dx
        mom = conf.p_mass * v[:, None, :] + jnp.einsum(
            "pij,poj->poi", affine, dpos
        )  # (P, 27, 3)
        vals = weight[..., None] * mom
        grid_v = jnp.zeros((n_cells, 3)).at[flat.reshape(-1)].add(vals.reshape(-1, 3))
        grid_m = jnp.zeros((n_cells,)).at[flat.reshape(-1)].add(
            (weight * conf.p_mass).reshape(-1)
        )
        return grid_v.reshape(res + (3,)), grid_m.reshape(res)

    def _g2p(self, x, grid_v):
        """Grid-to-particle: new particle velocities (P, 3) and APIC affine
        velocities (P, 3, 3)."""
        if self.transfer_mode == "dense":
            return self._g2p_dense(x, grid_v)
        conf = self.conf
        weight, flat, dpos_units = self._weights_and_indices(x)
        gv = grid_v.reshape(-1, 3)[flat]  # (P, 27, 3)
        new_v = jnp.sum(weight[..., None] * gv, axis=1)
        new_C = 4.0 * conf.inv_dx * jnp.einsum(
            "po,poi,poj->pij", weight, gv, dpos_units
        )
        return new_v, new_C

    def _substep(self, f, state: MPMState):
        conf = self.conf
        dt, dx = conf.dt, conf.dx

        liquid = self._material == WATER
        plastic = self._material == PLASTIC_CLIP
        vm = self._material == VON_MISES

        # --- deformation gradient update + stress ---
        F = (jnp.eye(3)[None, :, :] + dt * state.C) @ state.F

        h = jnp.clip(self._h, 0.1, 5.0)
        mu = state.mu * h
        la = state.lamda * h
        mu = jnp.where(liquid, 0.0, mu)
        la = jnp.where(liquid, 1.0, la)

        U, sig, Vh = svd3(F)

        # sigma-clip plasticity (mpm_simulator.py:249-258)
        sig_clipped = jnp.clip(sig, 1 - 2.5e-2 * 10, 1 + 4.5e-3 * 100)
        sig = jnp.where(plastic[:, None], sig_clipped, sig)
        J = sig.prod(-1)[:, None, None]
        F = jnp.where(
            plastic[:, None, None], U @ (jnp.eye(3)[None] * sig[..., None]) @ Vh, F
        )

        # von-Mises plasticity (Taichi mpm_simulator.py:134-150), in log-sigma space
        sig_vm = jnp.maximum(sig, 0.05)
        eps = jnp.log(sig_vm)
        eps_hat = eps - eps.mean(-1, keepdims=True)
        eps_hat_norm = jnp.sqrt(jnp.sum(eps_hat**2, -1, keepdims=True) + 1e-12)
        mu_col = jnp.broadcast_to(mu.reshape(-1, 1), eps.shape[:1] + (1,))
        delta_gamma = eps_hat_norm - state.yield_stress.reshape(-1, 1) / (2.0 * mu_col + 1e-12)
        yields = delta_gamma > 0
        # clip before use so the unselected where-branch stays finite (a
        # huge negative delta_gamma would exp-overflow and poison the VJP)
        delta_gamma_pos = jnp.clip(delta_gamma, 0.0, None)
        eps_proj = eps - (delta_gamma_pos / eps_hat_norm) * eps_hat
        sig_proj = jnp.where(yields, jnp.exp(eps_proj), sig_vm)
        F_vm = U @ (jnp.eye(3)[None] * sig_proj[..., None]) @ Vh
        F = jnp.where(vm[:, None, None], F_vm, F)

        R = U @ Vh
        stress = 2.0 * mu[:, None, None] * (F - R) @ jnp.swapaxes(F, -1, -2) + jnp.eye(3)[
            None
        ] * la[:, None, None] * J * (J - 1.0)
        stress = (-dt * conf.p_vol * 4.0) * stress / dx**2
        affine = stress + conf.p_mass * state.C
        state = state._replace(F=F)

        # --- P2G ---
        grid_v, grid_m = self._p2g(state.x, state.v, affine)

        # --- primitive FK ---
        primitives = tuple(forward_kinematics(f, p) for p in state.primitives)
        state = state._replace(primitives=primitives)

        # --- grid ops ---
        # momentum -> velocity with a mass threshold and guarded denominator:
        # the raw reference form (m > 0, divide by m) lets cells with
        # denormal masses (stencil-tail weights ~1e-14, which the dense
        # tensor-product transfer produces for every near-boundary node)
        # blow up the backward pass with 1/m^2 — the threshold is ~1e-5 of a
        # particle mass, physically invisible, and keeps the VJP finite.
        mass_mask = grid_m > 1e-10
        safe_m = jnp.where(mass_mask, grid_m, 1.0)
        grid_v = jnp.where(mass_mask[..., None], grid_v / safe_m[..., None], grid_v)
        grid_v = grid_v + dt * jnp.array(conf.gravity)

        grid_pos = self.grid_idx_3d.astype(jnp.float32) * dx
        for i, (collide, pos_control) in enumerate(self._colliders):
            if self.use_position_control:
                grid_v = pos_control(f, grid_pos, grid_v, dt, primitives[i])
            else:
                grid_v = collide(f, grid_pos, grid_v, dt, primitives[i])

        # ground friction on the bottom 3 grid layers (mpm_simulator.py:296-307)
        normal = jnp.array([0.0, 1.0, 0.0])
        gidx = self.grid_idx_3d.astype(jnp.float32)
        lin = jnp.einsum("xyzc,c->xyz", grid_v, normal) + 1e-30
        vit = grid_v - lin[..., None] * normal.reshape(1, 1, 1, 3) - gidx * 1e-30
        lit = jnp.linalg.norm(vit + 1e-12, axis=3)
        grid_v_fric = jnp.clip(
            1.0 + state.friction * lin[..., None] / lit[..., None], 0.0, jnp.inf
        ) * (vit + gidx * 1e-30)
        grid_v_fric = grid_v_fric.at[:, :, :, 1].set(0.0)
        friction_mask = jnp.zeros_like(grid_v).at[:, :3, :, :].set(1.0)
        fric_speed_mask = grid_v[..., 1] <= 0
        grid_v = jnp.where(friction_mask * fric_speed_mask[..., None], grid_v_fric, grid_v)

        # boundary: zero outgoing velocity within 3 cells of the box
        # (mpm_simulator.py:310-313 — note the upper bound uses n_grid, not
        # res, so with a focus region smaller than the full grid the upper
        # wall is open, exactly as in the reference)
        idx3 = self.grid_idx_3d
        cond = ((idx3 < 3) & (grid_v < 0)) | ((idx3 > conf.n_grid - 3) & (grid_v > 0))
        grid_v = jnp.where(cond, 0.0, grid_v)

        # --- G2P ---
        new_v, new_C = self._g2p(state.x, grid_v)

        x = state.x + dt * new_v
        J_new = state.J * (1.0 + dt * jnp.trace(new_C, axis1=-2, axis2=-1))
        return state._replace(x=x, v=new_v, C=new_C, J=J_new)

    # ------------------------------------------------------------------ #
    # macro step
    # ------------------------------------------------------------------ #

    def _build_step(self):
        conf = self.conf

        def substep_scan(state, f):
            return self._substep(f, state), None

        substep_scan = jax.checkpoint(substep_scan)

        def copy_frame(state: MPMState):
            prims = []
            for p in state.primitives:
                position = p.position.at[0].set(p.position[conf.steps])
                rotation = p.rotation.at[0].set(p.rotation[conf.steps])
                prims.append(p._replace(position=position, rotation=rotation))
            return state._replace(primitives=tuple(prims))

        def step(state: MPMState, action):
            state = scrub_mpm_state(state)
            action = clamp_grad_norm_tree(action)
            action = action.clip(-1.0, 1.0)

            prims = tuple(
                set_action(conf.steps, action[i * 6 : (i + 1) * 6], p)
                for i, p in enumerate(state.primitives)
            )
            state = state._replace(primitives=prims)

            state, _ = jax.lax.scan(
                substep_scan, state, jnp.arange(conf.steps), length=conf.steps
            )
            state = copy_frame(state)
            return state, state

        return step
