"""Cases shared by the dense-vs-scatter transfer parity tests
(test_mpm_transfer_materials.py, test_mpm_transfer_scenes.py).

The two transfers are independent implementations of the same quadratic
B-spline P2G/G2P (``MPMSimulator._p2g_dense``/``_g2p_dense`` against the
flat-index segment scatter/gather), so each checks the other: one macro
step's state, the action gradient and the material-parameter gradient must
agree for every material, collider and control mode the engine has.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from unidom_tpu.engine.mpm import (
    ELASTIC,
    PLASTIC_CLIP,
    VON_MISES,
    WATER,
    MPMConf,
    MPMSimulator,
)
from unidom_tpu.engine.primitives import create_primitive

# name -> (blocks [(material, size, init_pos)], sdf, primitive size, position
# control); every scene has one primitive that the action drives into the
# material, so the action gradient is not zero
SCENES = {
    "position_control": ([(ELASTIC, (0.12, 0.04, 0.08), (0.25, 0.06, 0.25))],
                         "box", (0.03, 0.03, 0.03), True),
    "collide": ([(ELASTIC, (0.12, 0.04, 0.08), (0.25, 0.06, 0.25))],
                "sphere", (0.03, 0.03, 0.03), False),
    "water": ([(WATER, (0.10, 0.06, 0.10), (0.25, 0.08, 0.25))],
              "box", (0.03, 0.03, 0.03), False),
    "elastic": ([(ELASTIC, (0.10, 0.06, 0.10), (0.25, 0.06, 0.25))],
                "box", (0.03, 0.03, 0.03), False),
    "plastic_clip": ([(PLASTIC_CLIP, (0.12, 0.04, 0.08), (0.25, 0.06, 0.25))],
                     "box", (0.03, 0.03, 0.03), False),
    "von_mises": ([(VON_MISES, (0.12, 0.04, 0.08), (0.25, 0.06, 0.25))],
                  "box", (0.03, 0.03, 0.03), False),
    "mixture": ([(WATER, (0.08, 0.05, 0.08), (0.22, 0.08, 0.25)),
                 (ELASTIC, (0.06, 0.04, 0.06), (0.30, 0.06, 0.25))],
                "box", (0.03, 0.03, 0.03), False),
    "container": ([(WATER, (0.08, 0.06, 0.08), (0.25, 0.12, 0.25))],
                  "container", (0.09, 0.0, 0.008), False),
}
STEPS = 4


def build(scene, transfer):
    blocks, sdf, prim_size, pos_control = SCENES[scene]
    conf = MPMConf(n_grid=32, dt=2e-4, steps=STEPS, E=100.0, nu=0.1,
                   yield_stress=5.0, res=(16, 16, 16), transfer=transfer,
                   task="t", goal_path="")
    sim = MPMSimulator(conf, 1, use_position_control=pos_control)
    state = None
    for material, size, pos in blocks:
        state = sim.add_box(state, size=size, init_pos=pos, material=material,
                            density=1.5 if material == WATER else 2.5)
    sim.register_primitive_sdf(sdf)
    state.primitives.append(create_primitive(
        conf.steps, friction=0.1, softness=666.0, color=[0.5, 0.5, 0.5],
        size=prim_size, init_pos=[0.25, 0.10, 0.17]))
    state = sim.reset(state)
    # a moving, sheared start so the affine (APIC) terms carry weight
    state = state._replace(
        v=jax.random.normal(jax.random.PRNGKey(0), state.v.shape) * 0.05,
        C=jax.random.normal(jax.random.PRNGKey(1), state.C.shape) * 0.5,
    )
    assert sim.transfer_mode == transfer
    return sim, state


def _loss(out):
    w = jnp.sin(jnp.arange(out.x.size, dtype=jnp.float32).reshape(out.x.shape))
    return jnp.sum(out.x * w) + 0.1 * jnp.sum(out.v)


@functools.lru_cache(maxsize=None)
def results(scene, transfer):
    """One macro step's state and the gradients of a fixed scalar with
    respect to the action and to the Lame parameters."""
    sim, state = build(scene, transfer)
    action = jnp.zeros((1, 6)).at[0, 2].set(0.4).at[0, 1].set(-0.1)

    def f(action, mu, lamda):
        out, _ = sim.step_batch(state._replace(mu=mu, lamda=lamda), action)
        return _loss(out), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        action, state.mu, state.lamda)
    return jax.device_get(out), jax.device_get(grads)


def assert_close(got, ref, tol):
    """max|got - ref| <= tol * max|ref|: float32 sums of 27 stencil terms
    err in proportion to the field's scale, not to each element."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max() + 1e-12, (err, np.abs(ref).max())


def check_forward(scene):
    d, _ = results(scene, "dense")
    s, _ = results(scene, "scatter")
    for field, tol in (("x", 1e-5), ("v", 1e-4), ("C", 1e-4), ("F", 1e-5),
                       ("J", 1e-5)):
        assert_close(getattr(d, field), getattr(s, field), tol)


def check_action_grad(scene):
    _, (ga_d, _, _) = results(scene, "dense")
    _, (ga_s, _, _) = results(scene, "scatter")
    assert np.all(np.isfinite(ga_d)) and np.abs(ga_d).sum() > 0
    assert_close(ga_d, ga_s, 1e-3)


def check_param_grad(scene):
    _, (_, gmu_d, gla_d) = results(scene, "dense")
    _, (_, gmu_s, gla_s) = results(scene, "scatter")
    assert np.all(np.isfinite(gmu_d)) and np.all(np.isfinite(gla_d))
    assert_close(gmu_d, gmu_s, 1e-3)
    assert_close(gla_d, gla_s, 1e-3)
