"""Target-driven losses for MPM trajectory optimization.

Reference: GenORM/policy/pbm/plb/engine/losses/loss.py:7-306 — a target
density grid defines (1) an L1 density loss, (2) an SDF loss (mass weighted
by distance-to-target), (3) a contact loss pulling the manipulator to the
material (hard min-distance or soft weighted distance), summed with
configurable weights; plus a mass-weighted IoU metric and the
reward/incremental-IoU bookkeeping of ``compute_loss``.

Design deltas:
- The target SDF is precomputed with a **jump-flooding transform** (log2(n)
  rounds of 26 masked shifts) instead of the reference's 2*n_grid sweeps of
  a 6^3 stencil (loss.py:81-106) — same nearest-point semantics, O(G log G).
- Everything is a pure jittable function; the loss state (start/last loss)
  is an explicit NamedTuple instead of Taichi field mutation.
"""

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def compute_grid_mass(x, res: Tuple[int, int, int], inv_dx: float, p_mass: float = 1.0):
    """Quadratic B-spline P2G of particle mass. x: (P, 3) -> (res) grid."""
    base = jnp.floor(x * inv_dx - 0.5).astype(jnp.int32)
    fx = x * inv_dx - base.astype(jnp.float32)
    w = jnp.stack(
        [0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2], axis=1
    )  # (P, 3, 3)
    offsets = jnp.asarray(
        [[i, j, k] for i in range(3) for j in range(3) for k in range(3)], jnp.int32
    )
    weight = (
        w[:, :, 0][:, :, None, None]
        * w[:, :, 1][:, None, :, None]
        * w[:, :, 2][:, None, None, :]
    ).reshape(-1, 27)
    node = base[:, None, :] + offsets[None]
    ok = jnp.all((node >= 0) & (node < jnp.asarray(res)), -1)
    weight = jnp.where(ok, weight, 0.0)
    node = jnp.clip(node, 0, jnp.asarray(res) - 1)
    flat = (node[..., 0] * res[1] + node[..., 1]) * res[2] + node[..., 2]
    grid = jnp.zeros((res[0] * res[1] * res[2],)).at[flat.reshape(-1)].add(
        (weight * p_mass).reshape(-1)
    )
    return grid.reshape(res)


def target_sdf_jfa(target_density, dx: float, threshold: float = 1e-4):
    """Distance-to-target field by jump flooding. Returns (sdf, nearest_point).

    Cells with target mass get sdf 0 and themselves as nearest point
    (loss.py:84-90); empty cells get the distance to the closest occupied
    cell center.
    """
    res = target_density.shape
    grids = jnp.stack(
        jnp.meshgrid(*[jnp.arange(r) for r in res], indexing="ij"), axis=-1
    ).astype(jnp.float32) * dx  # (X, Y, Z, 3)

    occupied = target_density > threshold
    INF = 1e9
    nearest = jnp.where(occupied[..., None], grids, INF)

    def dist(pts):
        return jnp.sqrt(jnp.sum((grids - pts) ** 2, -1) + 1e-8)

    offsets = [
        (i, j, k)
        for i in (-1, 0, 1)
        for j in (-1, 0, 1)
        for k in (-1, 0, 1)
        if (i, j, k) != (0, 0, 0)
    ]
    step = max(res) // 2
    while step >= 1:
        for (oi, oj, ok) in offsets:
            cand = jnp.roll(nearest, (oi * step, oj * step, ok * step), axis=(0, 1, 2))
            # cells rolled across the boundary are invalid: their coordinate
            # distance will be huge because nearest stores absolute positions
            better = dist(cand) < dist(nearest)
            nearest = jnp.where(better[..., None], cand, nearest)
        step //= 2

    sdf = jnp.where(occupied, 0.0, dist(nearest))
    sdf = jnp.where(jnp.any(nearest >= INF, -1), 1000.0, sdf)  # no target at all
    return sdf, nearest


class LossWeights(NamedTuple):
    sdf: jnp.ndarray = jnp.asarray(10.0)
    density: jnp.ndarray = jnp.asarray(10.0)
    contact: jnp.ndarray = jnp.asarray(1.0)


class TargetLoss:
    """Per-env target loss over (particles, primitives).

    Construct once per task with the target density grid; call
    ``losses(x, prim_sdf_dists)`` inside jit. Batch via vmap.
    """

    def __init__(self, target_density, res, inv_dx, weights: LossWeights = LossWeights(),
                 soft_contact: bool = False):
        self.res = tuple(res)
        self.inv_dx = inv_dx
        self.dx = 1.0 / inv_dx
        self.weights = weights
        self.soft_contact = soft_contact
        self.target_density = jnp.asarray(target_density)
        self.target_sdf, _ = jax.jit(target_sdf_jfa, static_argnums=1)(
            self.target_density, self.dx
        )
        self._target_iou = float(self.iou(self.target_density))

    @staticmethod
    def from_particles(points, res, inv_dx, **kw):
        density = compute_grid_mass(jnp.asarray(points), tuple(res), inv_dx)
        return TargetLoss(density, res, inv_dx, **kw)

    # ---------------- individual terms ---------------- #

    def density_loss(self, grid_mass):
        return jnp.abs(grid_mass - self.target_density).sum()

    def sdf_loss(self, grid_mass):
        return (self.target_sdf * grid_mass).sum()

    @staticmethod
    def _soft_weight(d):
        return 1.0 / (1.0 + d * d * 10000.0)

    def contact_loss(self, prim_dists: Sequence[jnp.ndarray]):
        """prim_dists: per-primitive (P,) SDF distance of every particle to
        the manipulator (clamped >= 0 by the caller or here)."""
        total = 0.0
        for d in prim_dists:
            d = jnp.maximum(d, 0.0)
            if self.soft_contact:
                w = self._soft_weight(d)
                min_dist = (d * w).sum() / (w.sum() + 1e-12)
            else:
                min_dist = d.min()
            total = total + min_dist**2
        return total

    def iou(self, grid_mass):
        """Mass-weighted IoU (iou_kernel, loss.py:239-256)."""
        ma = grid_mass.max()
        mb = self.target_density.max()
        I = (grid_mass * self.target_density).sum() / (ma * mb + 1e-30)
        U = grid_mass.sum() / (ma + 1e-30) + self.target_density.sum() / (mb + 1e-30)
        return I / (U - I + 1e-30)

    # ---------------- combined ---------------- #

    def losses(self, x, prim_dists: Sequence[jnp.ndarray] = ()):
        grid_mass = compute_grid_mass(x, self.res, self.inv_dx)
        d = self.density_loss(grid_mass)
        s = self.sdf_loss(grid_mass)
        c = self.contact_loss(prim_dists) if len(prim_dists) else jnp.asarray(0.0)
        total = (
            self.weights.sdf * s + self.weights.density * d + self.weights.contact * c
        )
        return {
            "loss": total,
            "sdf_loss": s,
            "density_loss": d,
            "contact_loss": c,
            "iou": self.iou(grid_mass),
            "target_iou": self._target_iou,
        }


class LossTracker(NamedTuple):
    """Explicit version of the reference's mutable reward bookkeeping
    (loss.py:281-302): reward = start_loss - step_loss; incremental IoU in
    [0, 1] against the target's self-IoU."""

    start_loss: jnp.ndarray
    last_loss: jnp.ndarray
    init_iou: jnp.ndarray

    @staticmethod
    def init(loss_info):
        return LossTracker(
            start_loss=loss_info["loss"],
            last_loss=jnp.zeros_like(loss_info["loss"]),
            init_iou=loss_info["iou"],
        )

    def step(self, loss_info):
        cur = loss_info["loss"] - self.last_loss
        reward = self.start_loss - cur
        inc_iou = jnp.clip(
            (loss_info["iou"] - self.init_iou)
            / (loss_info["target_iou"] - self.init_iou + 1e-12),
            0.0,
            1.0,
        )
        info = dict(loss_info)
        info.update({"reward": reward, "incremental_iou": inc_iou, "loss": cur})
        return self._replace(last_loss=loss_info["loss"]), info
