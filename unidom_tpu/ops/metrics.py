"""Task metrics: chamfer distance, mean L2, projection/voxel IoU.

Numerics match the reference definitions exactly (these feed the reward, so
they are part of the acceptance criteria) but the chamfer pairwise distance
is computed via a Gram-matrix expansion (one matmul) instead of
materializing (B, Nx, Ny, 3) broadcast tensors
(reference: DaXBench/daxbench/core/utils/util.py:128-159,
daxbench/core/envs/others/metric.py:4-27).
"""

import jax
import jax.numpy as jnp
import numpy as np


def _pairwise_rms(x, y):
    """dist[b, i, j] = sqrt(mean_d (x[b,i,d] - y[j,d])^2)  — note mean over the
    coordinate axis (the reference's convention), i.e. euclidean / sqrt(3)."""
    x2 = jnp.sum(x * x, axis=-1)  # (B, Nx)
    y2 = jnp.sum(y * y, axis=-1)  # (Ny,)
    xy = jnp.einsum("bid,jd->bij", x, y)
    d2 = x2[..., :, None] + y2[None, None, :] - 2.0 * xy
    return jnp.sqrt(jnp.clip(d2, 0.0, None) / x.shape[-1])


# Above this many pairwise-distance elements the (B, Nx, Ny) tensor (plus its
# BPTT residual) dominates HBM — e.g. fold_cloth3 @1024 envs x 512x512 goal is
# 1 GB *per macro step*. Chunk + remat instead.
_CHAMFER_DENSE_LIMIT = 2**26
_CHAMFER_CHUNK = 128


def chamfer(x, goal):
    """Bidirectional chamfer distance per batch element.

    x: (B, Nx, 3) particles; goal: (Ny, 3). Returns (B,).

    Large batches use a scan over x-chunks with ``jax.checkpoint`` so the
    pairwise block is recomputed in the backward pass instead of living in
    HBM for the whole BPTT horizon (numerically identical up to fp
    reassociation of the mean).
    """
    B, Nx, _ = x.shape
    Ny = goal.shape[0]
    chunk = _CHAMFER_CHUNK
    if B * Nx * Ny <= _CHAMFER_DENSE_LIMIT or Nx % chunk != 0:
        d = _pairwise_rms(x, goal)
        x2y = d.min(-1).mean(-1)
        y2x = d.min(-2).mean(-1)
        return x2y + y2x

    xc = x.reshape(B, Nx // chunk, chunk, 3).transpose(1, 0, 2, 3)

    @jax.checkpoint
    def body(carry, xi):
        x2y_sum, y2x_min = carry
        d = _pairwise_rms(xi, goal)  # (B, chunk, Ny)
        return (x2y_sum + d.min(-1).sum(-1), jnp.minimum(y2x_min, d.min(-2))), None

    init = (jnp.zeros((B,), x.dtype), jnp.full((B, Ny), jnp.inf, x.dtype))
    (x2y_sum, y2x_min), _ = jax.lax.scan(body, init, xc)
    return x2y_sum / Nx + y2x_min.mean(-1)


def l2_distance(x, goal):
    """Mean per-particle RMS distance to the index-aligned goal. x: (B, N, 3)."""
    return jnp.sqrt(((x - goal[None, ...]) ** 2).mean(-1)).mean(-1)


def grid_iou(x_proj, goal_map):
    """IoU of two binary top-down occupancy maps (projection IoU)."""
    inter = jnp.sum(x_proj * goal_map)
    union = jnp.sum(x_proj) + jnp.sum(goal_map) - inter
    return inter / union


def project_to_map(x, size=64):
    """Top-down binary occupancy map of a point cloud. x: (B, N, 3) -> (B, size, size)."""
    x = jnp.clip(x, 0.0, 1.0)
    ij = (x[..., [2, 0]] * size).astype(jnp.int32)  # row=z, col=x
    ij = jnp.clip(ij, 0, size - 1)
    flat = ij[..., 0] * size + ij[..., 1]
    maps = jnp.zeros((x.shape[0], size * size), dtype=jnp.float32)
    maps = maps.at[jnp.arange(x.shape[0])[:, None], flat].set(1.0)
    return maps.reshape(x.shape[0], size, size)


def voxel_iou(curr_pc, goal_pc, n_grid=64):
    """Ground-plane voxel IoU between two point clouds (numpy, host-side eval)."""
    goal_pc = np.round(np.asarray(goal_pc) * n_grid).astype(np.int32)
    goal_pc = np.clip(goal_pc, 0, n_grid - 1)
    goal_vox = np.zeros((n_grid, n_grid), dtype=np.int32)
    goal_vox[goal_pc[:, 0], goal_pc[:, 2]] = 1

    curr_pc = np.round(np.asarray(curr_pc) * n_grid).astype(np.int32)
    curr_pc = np.clip(curr_pc, 0, n_grid - 1)
    curr_vox = np.zeros((n_grid, n_grid), dtype=np.int32)
    curr_vox[curr_pc[:, 0], curr_pc[:, 2]] = 1

    merged = goal_vox + curr_vox
    inter = (merged == 2).sum()
    union = (merged > 0).sum()
    return 1.0 * inter / union
