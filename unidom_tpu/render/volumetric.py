"""Volumetric SDF ray-march renderer (JAX).

Re-design of the reference's Taichi path tracer
(GenORM/policy/pbm/plb/engine/renderer/renderer.py:22-530):

- ``build_sdf_from_particles`` (renderer.py:102-132): the reference
  atomic-min's a packed (dist<<24 | rgb) int into every voxel within
  ``bake_size`` of each particle, unpacks to a truncated distance field
  (0.2 * voxel distance, clamped to [0, 1]) + color volume, then box-smooths
  twice. We seed one particle per occupied voxel and propagate the nearest
  seed *position and color* by jump flooding (O(G log G) instead of
  O(P * bake_size^3) scatters), producing the same truncated field, then
  apply the same two 3x3x3 box smooths.
- ``next_hit`` / ``trace`` / ``render`` (renderer.py:204-455): rays are
  generated with the same camera model (fov 0.23, yaw/pitch rotation,
  jittered AA), sphere-march the trilinearly-sampled SDF with the same step
  rule (max(0.05 * s, 0.01)) and 20-iteration bisection refinement, hit the
  same analytic ground/back-wall planes, and shade with the reference's
  default config: sky-lit diffuse path tracing with max_ray_depth bounces
  (use_directional_light=False), cosine-weighted bounce directions with
  roughness glossiness, and the same sqrt/vignette/exposure tone map
  (renderer.py:413-426).

Everything is fixed-iteration, masked ``fori_loop`` control flow vectorized
over all rays — no data-dependent while loops — so the whole frame is one
XLA program. Analytic primitive SDFs (ops/sdf.py) are sphere-traced like
renderer.py:236-257.
"""

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

FOV = 0.23  # renderer.py:13
DIST_LIMIT = 100.0  # renderer.py:14
EXPOSURE = 1.5  # renderer.py:16
INF = 1e9


@dataclass
class VolumeConf:
    """Defaults mirror plb/config/default_config.py:41-59."""

    image_res: Tuple[int, int] = (512, 512)
    voxel_res: Tuple[int, int, int] = (168, 168, 168)
    dx: float = 1.0 / 150
    sdf_threshold: float = 0.65 * 0.56
    bake_size: int = 6
    max_ray_depth: int = 2
    spp: int = 10
    camera_pos: Tuple[float, float, float] = (0.5, 1.2, 4.0)
    camera_rot: Tuple[float, float] = (0.2, 0.0)
    light_direction: Tuple[float, float, float] = (2.0, 1.0, 0.7)
    use_directional_light: bool = False
    ground_color: Tuple[float, float, float] = (0.3, 0.5, 0.7)
    march_steps: int = 160  # fixed-iteration budget for the SDF march
    prim_march_steps: int = 64


# ------------------------------------------------------------------ #
# particle -> (sdf, color) volume
# ------------------------------------------------------------------ #


def particle_bbox(x, dx, voxel_res):
    """Reference bbox rule (renderer.py:458-478): floor to the grid, pad by
    6 cells, then stretch to exactly voxel_res cells."""
    lo = (jnp.floor(x.min(0) / dx) - 6.0) * dx
    hi = lo + jnp.asarray(voxel_res, jnp.float32) * dx
    return lo, hi


def _box_smooth(vol):
    """3^3 box filter with boundary := 1 (renderer.py:88-99), applied twice
    per call site like smooth(sdf, copy); smooth(copy, sdf)."""
    out = vol
    for _ in range(2):
        s = jnp.zeros_like(out)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    s = s + jnp.roll(out, (di, dj, dk), axis=(0, 1, 2))
        inner = s / 27.0
        out = jnp.ones_like(out)
        out = out.at[1:-1, 1:-1, 1:-1].set(inner[1:-1, 1:-1, 1:-1])
    return out


@partial(jax.jit, static_argnames=("voxel_res", "dx", "bake_size"))
def build_sdf_from_particles(x, color, bbox_lo, voxel_res, dx, bake_size=6):
    """x: (P, 3) world positions, color: (P, 3) in [0, 1].

    Returns (sdf, color_vol): sdf = clamp(0.2 * dist_in_voxels, 0, 1)
    box-smoothed twice (renderer.py:115-131); color_vol = nearest particle's
    color.
    """
    res = voxel_res
    inv_dx = 1.0 / dx
    p_vox = (x - bbox_lo[None]) * inv_dx  # particle coords in voxel units

    cell = jnp.clip(p_vox.astype(jnp.int32), 0, jnp.asarray(res) - 1)
    flat = (cell[:, 0] * res[1] + cell[:, 1]) * res[2] + cell[:, 2]
    # one seed per occupied voxel: the min particle index wins
    P = x.shape[0]
    seed_idx = jnp.full((res[0] * res[1] * res[2],), P, jnp.int32).at[flat].min(
        jnp.arange(P, dtype=jnp.int32)
    )
    occupied = seed_idx < P
    safe = jnp.where(occupied, seed_idx, 0)
    seed_pos = jnp.where(occupied[:, None], p_vox[safe], INF).reshape(res + (3,))
    seed_col = jnp.where(occupied[:, None], color[safe], 0.0).reshape(res + (3,))

    centers = jnp.stack(
        jnp.meshgrid(*[jnp.arange(r, dtype=jnp.float32) for r in res], indexing="ij"),
        axis=-1,
    )

    def dist(p):
        return jnp.sqrt(jnp.sum((centers - p) ** 2, -1) + 1e-12)

    offsets = [
        (i, j, k)
        for i in (-1, 0, 1)
        for j in (-1, 0, 1)
        for k in (-1, 0, 1)
        if (i, j, k) != (0, 0, 0)
    ]
    nearest, near_col = seed_pos, seed_col
    step = max(bake_size, 1)
    while step >= 1:
        for (oi, oj, ok) in offsets:
            shift = (oi * step, oj * step, ok * step)
            cand = jnp.roll(nearest, shift, axis=(0, 1, 2))
            cand_c = jnp.roll(near_col, shift, axis=(0, 1, 2))
            better = dist(cand) < dist(nearest)
            nearest = jnp.where(better[..., None], cand, nearest)
            near_col = jnp.where(better[..., None], cand_c, near_col)
        step //= 2

    sdf = jnp.clip(0.2 * dist(nearest), 0.0, 1.0)  # renderer.py:118 scaling
    sdf = jnp.where(jnp.any(nearest >= INF, -1), 1.0, sdf)
    return _box_smooth(sdf), near_col


# ------------------------------------------------------------------ #
# sampling
# ------------------------------------------------------------------ #


def _sample_trilinear(vol, pos01, res):
    """Trilinear sample at normalized [0,1]^3 coords (renderer.py:139-155)."""
    p = pos01 * jnp.asarray(res, jnp.float32)
    base = jnp.minimum(p.astype(jnp.int32), jnp.asarray(res) - 1)
    base = jnp.maximum(base, 0)
    f = p - base.astype(jnp.float32)
    x, y, z = base[..., 0], base[..., 1], base[..., 2]
    x1 = jnp.minimum(x + 1, res[0] - 1)
    y1 = jnp.minimum(y + 1, res[1] - 1)
    z1 = jnp.minimum(z + 1, res[2] - 1)
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    if vol.ndim == 3:
        v = vol[..., None]
    else:
        v = vol
    c00 = v[x, y, z] * (1 - fx) + v[x1, y, z] * fx
    c01 = v[x, y, z1] * (1 - fx) + v[x1, y, z1] * fx
    c10 = v[x, y1, z] * (1 - fx) + v[x1, y1, z] * fx
    c11 = v[x, y1, z1] * (1 - fx) + v[x1, y1, z1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    out = c0 * (1 - fz) + c1 * fz
    return out[..., 0] if vol.ndim == 3 else out


def _make_samplers(sdf_vol, color_vol, bbox_lo, bbox_hi, res, threshold):
    extent = bbox_hi - bbox_lo

    def sample_sdf(p):
        q = (p - bbox_lo) / extent
        inside = (q.min(-1) >= 0.0) & (q.max(-1) <= 1.0)
        return jnp.where(inside, _sample_trilinear(sdf_vol, q, res) - threshold, 0.0)

    def sample_color(p):
        q = jnp.clip((p - bbox_lo) / extent, 0.0, 1.0)
        return _sample_trilinear(color_vol, q, res)

    def sample_normal(p):
        d = 1e-3  # renderer.py:177
        eye = jnp.eye(3) * d
        n = jnp.stack(
            [(sample_sdf(p + eye[i]) - sample_sdf(p - eye[i])) * (0.5 / d) for i in range(3)],
            -1,
        )
        return n / (jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)

    return sample_sdf, sample_color, sample_normal


# ------------------------------------------------------------------ #
# hit logic (vectorized over rays)
# ------------------------------------------------------------------ #


def _ray_aabb(lo, hi, o, d):
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tnear = jnp.minimum(t0, t1).max(-1)
    tfar = jnp.maximum(t0, t1).min(-1)
    return (tfar >= tnear) & (tfar > 0), tnear, tfar


def _ground_color(p, base):
    checker = (
        (jnp.floor(p[..., 0] / 0.25).astype(jnp.int32)
         + jnp.floor(p[..., 2] / 0.25).astype(jnp.int32)) % 2
    ).astype(jnp.float32) * 0.2 + 0.35
    inb = (p[..., 0] >= 0) & (p[..., 0] <= 1) & (p[..., 2] >= 0) & (p[..., 2] <= 1)
    fac = jnp.where(inb, checker, 0.4)
    return jnp.asarray(base) * fac[..., None]


def _sky_color(d):
    """renderer.py:340-345."""
    c = jnp.clip(jnp.einsum("...d,d->...", d, jnp.asarray([0.8, 0.65, 0.15])) * 0.5 + 0.5, 0, 1)
    return (c[..., None] * jnp.asarray([0.9, 0.9, 0.9])
            + (1 - c[..., None]) * jnp.asarray([0.7, 0.7, 0.8])) * 1.5


def _next_hit(o, d, samplers, conf, bbox_lo, bbox_hi, primitives):
    """Vectorized next_hit (renderer.py:204-330). o, d: (R, 3).

    Returns closest, normal, color, roughness (all (R, ...))."""
    sample_sdf, sample_color, sample_normal = samplers
    R = o.shape[0]
    closest = jnp.full((R,), jnp.inf)
    normal = jnp.zeros((R, 3))
    color = jnp.zeros((R, 3))
    rough = jnp.zeros((R,))

    # back wall at z = -5.5 (renderer.py:213-221)
    tz = -(o[:, 2] + 5.5) / jnp.where(jnp.abs(d[:, 2]) < 1e-12, 1e-12, d[:, 2])
    hit_wall = (jnp.abs(d[:, 2]) > 0) & (tz > 0) & (tz < closest)
    closest = jnp.where(hit_wall, tz, closest)
    normal = jnp.where(hit_wall[:, None], jnp.asarray([0.0, 0.0, 1.0]), normal)
    color = jnp.where(hit_wall[:, None], jnp.asarray([0.6, 0.7, 0.7]), color)

    # ground plane y = -0.002 (renderer.py:224-231)
    tg = (o[:, 1] + 0.002) / jnp.where(jnp.abs(d[:, 1]) < 1e-12, 1e-12, -d[:, 1])
    hit_g = (d[:, 1] < 0) & (tg < DIST_LIMIT) & (tg < closest)
    gc = _ground_color(o + d * tg[:, None], conf.ground_color)
    closest = jnp.where(hit_g, tg, closest)
    normal = jnp.where(hit_g[:, None], jnp.asarray([0.0, 1.0, 0.0]), normal)
    color = jnp.where(hit_g[:, None], gc, color)

    # analytic primitives, sphere-traced (renderer.py:236-257)
    if primitives:
        def prim_min(p):
            ds = jnp.stack([sdf_fn(p) for sdf_fn, _ in primitives], -1)
            return ds.min(-1), ds.argmin(-1)

        def body(_, carry):
            t, done = carry
            p = o + t[:, None] * d
            s, _ = prim_min(p)
            done = done | (s < 1e-6) | (t > DIST_LIMIT)
            return t + jnp.where(done, 0.0, s), done

        t, done = jax.lax.fori_loop(
            0, conf.prim_march_steps, body,
            (jnp.zeros((R,)), jnp.zeros((R,), bool)),
        )
        p = o + t[:, None] * d
        s, sid = prim_min(p)
        hit_p = (s < 1e-4) & (t < DIST_LIMIT) & (t < closest)
        eps = 1e-4
        eye = jnp.eye(3) * eps
        pn = jnp.stack(
            [(prim_min(p + eye[i])[0] - prim_min(p - eye[i])[0]) / (2 * eps) for i in range(3)],
            -1,
        )
        pn = pn / (jnp.linalg.norm(pn, axis=-1, keepdims=True) + 1e-12)
        pcol = jnp.stack([jnp.asarray(c, jnp.float32) for _, c in primitives])[sid]
        closest = jnp.where(hit_p, t, closest)
        normal = jnp.where(hit_p[:, None], pn, normal)
        color = jnp.where(hit_p[:, None], pcol, color)

    # the particle SDF volume (renderer.py:261-288)
    ok, tnear, tfar = _ray_aabb(bbox_lo, bbox_hi, o, d)
    tnear = jnp.maximum(tnear, 0.0) + 1e-4

    def march_body(_, carry):
        t, hit = carry
        p = o + t[:, None] * d
        s = sample_sdf(p)
        hit = hit | (s < 0)
        step = jnp.maximum(s * 0.05, 0.01)  # renderer.py:287
        t_new = t + jnp.where(hit | ~ok | (t > tfar), 0.0, step)
        return t_new, hit

    t, hit_v = jax.lax.fori_loop(
        0, conf.march_steps, march_body, (tnear, jnp.zeros((R,), bool))
    )
    hit_v = hit_v & ok

    # 20-iteration bisection back-step (renderer.py:268-273)
    def refine(_, carry):
        t, back = carry
        back = back * 0.5
        inside = sample_sdf(o + (t - back)[:, None] * d) < 0
        return jnp.where(inside & hit_v, t - back, t), back

    back0 = jnp.maximum(sample_sdf(o + t[:, None] * d) * 0.0 + 0.01, 0.01)
    t, _ = jax.lax.fori_loop(0, 20, refine, (t, back0))

    pv = o + t[:, None] * d
    hit_v = hit_v & (t < closest)
    closest = jnp.where(hit_v, t, closest)
    normal = jnp.where(hit_v[:, None], sample_normal(pv), normal)
    color = jnp.where(hit_v[:, None], sample_color(pv), color)
    rough = jnp.where(hit_v, 0.05, rough)  # renderer.py:208

    return closest, normal, color, rough


def _cosine_dir(key, normal):
    """Cosine-weighted hemisphere direction around ``normal``."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, normal.shape[:-1])
    u2 = jax.random.uniform(k2, normal.shape[:-1])
    r = jnp.sqrt(u1)
    phi = 2 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.clip(1 - u1, 0.0, 1.0))
    up = jnp.where(
        (jnp.abs(normal[..., 2:3]) < 0.999),
        jnp.asarray([0.0, 0.0, 1.0]),
        jnp.asarray([1.0, 0.0, 0.0]),
    ) * jnp.ones_like(normal)
    tang = jnp.cross(up, normal)
    tang = tang / (jnp.linalg.norm(tang, axis=-1, keepdims=True) + 1e-12)
    bit = jnp.cross(normal, tang)
    return tang * x[..., None] + bit * y[..., None] + normal * z[..., None]


def _sphere_dir(key, shape):
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, shape)
    v = jax.random.uniform(k2, shape)
    x = u * 2 - 1
    phi = v * 2 * jnp.pi
    yz = jnp.sqrt(jnp.clip(1 - x * x, 0.0, 1.0))
    return jnp.stack([x, yz * jnp.cos(phi), yz * jnp.sin(phi)], -1)


# ------------------------------------------------------------------ #
# frame
# ------------------------------------------------------------------ #


def render_frame_fn(sdf_vol, color_vol, bbox_lo, bbox_hi, conf: VolumeConf,
                    key, primitives=()):
    """One full frame: (H, W, 3) float in [0, 1]. Pure; jit around it."""
    H, W = conf.image_res
    res = conf.voxel_res
    samplers = _make_samplers(sdf_vol, color_vol, bbox_lo, bbox_hi, res,
                              conf.sdf_threshold)

    rot_y, rot_x = conf.camera_rot[1], conf.camera_rot[0]
    mat = jnp.asarray(
        np.array([
            [np.cos(rot_y), 0.0, np.sin(rot_y)],
            [0.0, 1.0, 0.0],
            [-np.sin(rot_y), 0.0, np.cos(rot_y)],
        ]) @ np.array([
            [1.0, 0.0, 0.0],
            [0.0, np.cos(rot_x), np.sin(rot_x)],
            [0.0, -np.sin(rot_x), np.cos(rot_x)],
        ]),
        jnp.float32,
    )
    cam = jnp.asarray(conf.camera_pos)
    aspect = H / W

    uu, vv = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    Rn = uu.shape[0]

    def one_sample(key):
        ka, kb, kc, kd = jax.random.split(key, 4)
        ju = jax.random.uniform(ka, (Rn,))
        jv = jax.random.uniform(kb, (Rn,))
        d = jnp.stack([
            2 * FOV * (uu + ju) / W - FOV * aspect - 1e-5,
            2 * FOV * (vv + jv) / W - FOV - 1e-5,
            -jnp.ones((Rn,)),
        ], -1)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        d = d @ mat.T
        o = jnp.broadcast_to(cam, (Rn, 3))

        throughput = jnp.ones((Rn, 3))
        alive = jnp.ones((Rn,), bool)  # still bouncing (has not escaped)
        keys = jax.random.split(kc, conf.max_ray_depth)
        for depth in range(conf.max_ray_depth):
            closest, normal, c, rough = _next_hit(
                o, d, samplers, conf, bbox_lo, bbox_hi, primitives
            )
            hit = alive & (jnp.linalg.norm(normal, axis=-1) > 0)
            hit_pos = o + closest[:, None] * d
            kd1, kd2 = jax.random.split(keys[depth])
            out_dir = _cosine_dir(kd1, normal)
            glossy = _sphere_dir(kd2, (Rn,)) * rough[:, None]
            nd = out_dir + glossy
            nd = nd / (jnp.linalg.norm(nd, axis=-1, keepdims=True) + 1e-12)
            throughput = jnp.where(hit[:, None], throughput * c, throughput)
            o = jnp.where(hit[:, None], hit_pos + 1e-4 * nd, o)
            d = jnp.where(hit[:, None], nd, d)
            alive = hit  # rays that escaped keep their direction

        return throughput * _sky_color(d)

    keys = jax.random.split(key, conf.spp)
    acc = jnp.zeros((Rn, 3))
    for k in keys:  # unrolled: spp is small and static
        acc = acc + one_sample(k)

    # tone map (renderer.py:413-426)
    u01 = uu / H
    v01 = vv / W
    darken = 1.0 - 0.9 * jnp.maximum(
        jnp.sqrt((u01 - 0.5) ** 2 + (v01 - 0.5) ** 2) - 0.0, 0.0
    )
    img = jnp.sqrt(acc * darken[:, None] * EXPOSURE / conf.spp)
    img = img.reshape(H, W, 3)
    # opencv orientation (renderer.py:508): flip v, transpose
    return jnp.clip(img[:, ::-1].transpose(1, 0, 2), 0.0, 1.0)


class VolumeRenderer:
    """Stateful front-end mirroring the reference Renderer API
    (set_particles / render_frame)."""

    def __init__(self, conf: VolumeConf = None, primitives=()):
        self.conf = conf or VolumeConf()
        self.primitives = tuple(primitives)
        self._frame = jax.jit(
            lambda sdf, col, lo, hi, key: render_frame_fn(
                sdf, col, lo, hi, self.conf, key, self.primitives
            )
        )
        self.sdf_vol = None

    def set_particles(self, x, color=None):
        x = jnp.asarray(x)
        if color is None:
            color = jnp.broadcast_to(jnp.asarray([0.62, 0.55, 0.8]), x.shape)
        self.bbox_lo, self.bbox_hi = particle_bbox(x, self.conf.dx, self.conf.voxel_res)
        self.sdf_vol, self.color_vol = build_sdf_from_particles(
            x, jnp.asarray(color), self.bbox_lo,
            self.conf.voxel_res, self.conf.dx, self.conf.bake_size,
        )

    def render_frame(self, key=None, spp=None):
        assert self.sdf_vol is not None, "call set_particles first"
        key = key if key is not None else jax.random.PRNGKey(0)
        img = self._frame(self.sdf_vol, self.color_vol, self.bbox_lo, self.bbox_hi, key)
        return np.asarray((img * 255).astype(jnp.uint8))
