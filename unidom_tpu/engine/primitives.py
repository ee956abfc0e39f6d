"""Rigid collider primitives for the MPM engine.

Quaternion forward kinematics over a per-macro-step substep buffer, SDF
collision with softness-weighted influence and Coulomb friction, and a
position-control mode (semantics:
DaXBench/daxbench/core/engine/primitives/primitives.py:9-239).

Design deltas:
- The SDF is a static per-primitive callable chosen at env-construction time
  (from ``unidom_tpu.ops.sdf``), not a module-global ``set_sdf`` side channel
  (primitives.py:26-28) — traces stay pure.
- Normals are exact autodiff normals of the SDF instead of 6-point finite
  differences (primitives.py:117-134).
- The position/rotation substep buffers have ``steps + 1`` entries so the
  final forward-kinematics write at ``f = steps - 1`` lands in bounds. The
  reference sizes them ``steps`` and silently drops that last write
  (primitives.py:41-44,185-194 with jnp out-of-bounds ``.at[].set`` drop
  semantics), losing 1/steps of each commanded motion; we keep it.
"""

from typing import NamedTuple

import jax.numpy as jnp

from unidom_tpu.ops.sdf import get_sdf, sdf_normal
from unidom_tpu.ops.quat import qmul, qrot, qinv, w2quat


class PrimitiveState(NamedTuple):
    """Dynamic state of one rigid primitive (per env; batch via vmap)."""

    size: jnp.ndarray  # (3,) SDF size parameters
    friction: jnp.ndarray  # () collider friction
    softness: jnp.ndarray  # () contact softness (suction when driven to 0)
    color: jnp.ndarray  # (3,) render color
    position: jnp.ndarray  # (steps + 1, 3) substep position buffer
    rotation: jnp.ndarray  # (steps + 1, 4) substep quaternion buffer
    v: jnp.ndarray  # (steps, 3) linear velocity per substep
    w: jnp.ndarray  # (steps, 3) angular velocity per substep
    action_buffer: jnp.ndarray  # (6,) last macro action
    action_scale: jnp.ndarray  # (6,)


def create_primitive(steps, friction, softness, color, size, init_pos):
    """Build an initial PrimitiveState with ``steps + 1`` buffer entries."""
    position = jnp.zeros((steps + 1, 3)).at[0].set(jnp.asarray(init_pos, jnp.float32))
    rotation = jnp.zeros((steps + 1, 4)).at[:, 0].set(1.0)
    return PrimitiveState(
        size=jnp.asarray(size, jnp.float32),
        friction=jnp.asarray(friction, jnp.float32),
        softness=jnp.asarray(softness, jnp.float32),
        color=jnp.asarray(color, jnp.float32),
        position=position,
        rotation=rotation,
        v=jnp.zeros((steps, 3)),
        w=jnp.zeros((steps, 3)),
        action_buffer=jnp.zeros(6),
        action_scale=jnp.ones(6),
    )


def set_action(n_substeps, action, state: PrimitiveState):
    """Spread a (6,) macro action uniformly over the substep v/w buffers
    (primitives.py:212-229, vectorized instead of a python write loop)."""
    state = state._replace(action_buffer=action)
    v = jnp.broadcast_to(action[:3] * state.action_scale[:3] / n_substeps, (n_substeps, 3))
    w = jnp.broadcast_to(action[3:] * state.action_scale[3:] / n_substeps, (n_substeps, 3))
    return state._replace(v=v, w=w)


def forward_kinematics(f, state: PrimitiveState):
    """Advance the substep buffers: position[f+1], rotation[f+1]."""
    position = state.position.at[f + 1].set(state.position[f] + state.v[f])
    position = jnp.clip(position, -2.0, 2.0)
    rotation = state.rotation.at[f + 1].set(qmul(w2quat(state.w[f]), state.rotation[f]))
    return state._replace(position=position, rotation=rotation)


def _to_local(p, position, rotation):
    return qrot(qinv(rotation), p - position)


def make_collider(sdf_name):
    """Build (collide, position_control) closures over a statically chosen SDF."""
    sdf = get_sdf(sdf_name)
    normal = sdf_normal(sdf)

    def sdf_world(f, grid_pos, state: PrimitiveState):
        local = _to_local(grid_pos, state.position[f], state.rotation[f])
        return sdf(state.size, local)

    def normal_world(f, grid_pos, state: PrimitiveState):
        local = _to_local(grid_pos, state.position[f], state.rotation[f])
        return qrot(state.rotation[f], normal(state.size, local))

    def collider_v(f, grid_pos, dt, state: PrimitiveState):
        relative = qrot(qinv(state.rotation[f]), grid_pos - state.position[f])
        new_pos = qrot(state.rotation[f + 1], relative) + state.position[f + 1]
        return (new_pos - grid_pos) / dt

    def collide(f, grid_pos, v_out, dt, state: PrimitiveState):
        """Softness-weighted rigid collision with Coulomb friction
        (primitives.py:154-182). grid_pos/v_out: (..., 3)."""
        dist = sdf_world(f, grid_pos, state)
        influence = jnp.clip(jnp.exp(-dist * state.softness), -jnp.inf, 1.0)[..., None]

        D = normal_world(f, grid_pos, state)
        cv = collider_v(f, grid_pos, dt, state)
        input_v = v_out - cv

        normal_component = jnp.sum(input_v * D, axis=-1, keepdims=True)
        grid_v_t = input_v - jnp.clip(normal_component, -jnp.inf, 0.0) * D

        grid_v_t_dot = jnp.sum(grid_v_t * grid_v_t, axis=-1, keepdims=True)
        grid_v_t_norm = jnp.sqrt(grid_v_t_dot + 1e-12)
        grid_v_t_friction = (
            grid_v_t
            / grid_v_t_norm
            * jnp.clip(grid_v_t_norm + normal_component * state.friction, 1e-12, jnp.inf)
        )

        flag = (
            (normal_component < 0).astype(jnp.float32)
            * (jnp.sqrt(grid_v_t_dot) > 1e-12).astype(jnp.float32)
        )
        grid_v_t = grid_v_t_friction * flag + grid_v_t * (1.0 - flag)
        return cv + input_v * (1.0 - influence) + grid_v_t * influence

    def position_control(f, grid_pos, v_out, dt, state: PrimitiveState):
        """Kinematic control: grid cells within 1.5 x size[0] of the surface
        take the primitive's velocity (primitives.py:232-239)."""
        dist = sdf_world(f, grid_pos, state)
        control_mask = dist < state.size[0] * 1.5
        return jnp.where(control_mask[..., None], state.v[f] / dt, v_out)

    return collide, position_control
