"""Dependency-free software renderer for eval GIFs and debugging.

The reference's renderers (DaXBench pyrender EGL scenes,
engine/pyrender/py_render.py:16-191, and the Taichi ray-marcher,
plb/engine/renderer/renderer.py:22-530) need a GL stack. For headless
machines this module renders orthographic/simple-perspective point and mesh
views in pure numpy — enough for training GIFs, goal inspection, and CI.
pyrender, when installed, is used instead via unidom_tpu.render.mesh.
"""

import numpy as np


def _shade(height, lo=0.0, hi=0.3):
    t = np.clip((height - lo) / (hi - lo + 1e-9), 0, 1)
    # blue -> cyan -> yellow ramp
    r = np.clip(2 * t - 0.5, 0, 1)
    g = 0.3 + 0.7 * t
    b = 1.0 - 0.8 * t
    return np.stack([r, g, b], -1)


def render_points_topdown(points, size=256, radius=1, bg=0.12, extra=None):
    """Top-down (y-up) view of points in the unit box. Returns (size, size, 3)
    uint8. ``extra``: optional list of (xyz, rgb, px_radius) markers."""
    img = np.full((size, size, 3), bg, np.float32)
    pts = np.asarray(points)
    if pts.size:
        pts = pts[np.isfinite(pts).all(-1)]  # inactive grippers are NaN
    if pts.size:
        px = np.clip((pts[:, 0] * size).astype(int), 0, size - 1)
        py = np.clip((pts[:, 2] * size).astype(int), 0, size - 1)
        order = np.argsort(pts[:, 1])  # paint low first, high last
        colors = _shade(pts[:, 1])
        for dx in range(-radius, radius + 1):
            for dz in range(-radius, radius + 1):
                qx = np.clip(px + dx, 0, size - 1)
                qy = np.clip(py + dz, 0, size - 1)
                img[qy[order], qx[order]] = colors[order]
    for (xyz, rgb, r) in extra or []:
        if not np.all(np.isfinite(np.asarray(xyz, dtype=np.float64)[:3])):
            continue  # e.g. a gripper that has not picked yet
        cx = int(np.clip(float(xyz[0]), 0.0, 1.0) * (size - 1))
        cy = int(np.clip(float(xyz[2]), 0.0, 1.0) * (size - 1))
        y0, y1 = max(cy - r, 0), min(cy + r + 1, size)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, size)
        img[y0:y1, x0:x1] = rgb
    return (img * 255).astype(np.uint8)


def render_points_front(points, size=256, radius=1, bg=0.12):
    """Front view (x horizontal, y vertical)."""
    img = np.full((size, size, 3), bg, np.float32)
    pts = np.asarray(points)
    if pts.size:
        pts = pts[np.isfinite(pts).all(-1)]
    if pts.size:
        px = np.clip((pts[:, 0] * size).astype(int), 0, size - 1)
        py = np.clip(((1.0 - pts[:, 1] * 2.0) * (size - 1)).astype(int), 0, size - 1)
        order = np.argsort(-pts[:, 2])
        colors = _shade(pts[:, 1])
        for dx in range(-radius, radius + 1):
            for dz in range(-radius, radius + 1):
                qx = np.clip(px + dx, 0, size - 1)
                qy = np.clip(py + dz, 0, size - 1)
                img[qy[order], qx[order]] = colors[order]
    return (img * 255).astype(np.uint8)


def render_side_by_side(points, goal=None, size=256):
    """Topdown | front composite, optionally with the goal overlaid faintly."""
    top = render_points_topdown(points, size)
    front = render_points_front(points, size)
    if goal is not None:
        gtop = render_points_topdown(goal, size, bg=0.0).astype(np.float32)
        top = np.clip(top.astype(np.float32) + 0.25 * gtop, 0, 255).astype(np.uint8)
    return np.concatenate([top, front], axis=1)


def save_gif(frames, path, fps=20):
    """Write a GIF via imageio when present, else PNG frames."""
    try:
        import imageio

        imageio.mimsave(path, frames, duration=1000 / fps)
        return path
    except Exception:
        import os

        base = os.path.splitext(path)[0]
        os.makedirs(base, exist_ok=True)
        from PIL import Image

        for i, f in enumerate(frames):
            Image.fromarray(f).save(f"{base}/{i:04d}.png")
        return base
