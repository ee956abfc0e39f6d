"""Run the REFERENCE's own cloth envs + APG training to record the cost
baseline the ±5% parity target is measured against (round-2 verdict,
"Next round" #3a).

The reference stack cannot run unmodified here (brax 0.0.13 absent,
`jax.random.KeyArray` removed from jax, pyrender/gym not installed), so this
driver:
  * shims `jax.random.KeyArray = jax.Array` before any daxbench import
    (cloth_simulator.py:10),
  * stubs pyrender/pyglet/trimesh/gym with import-satisfying fakes (only the
    renderer path touches them; training never calls it),
  * replaces the brax-only trainer plumbing (apg.py:29-443) with a minimal
    driver that reproduces its exact update semantics: MLP [512,256,2*act]
    swish -> NormalTanh sample -> sigmoid, loss = -mean(reward) over the
    ep_len scan, grad -> nan_to_num -> global-norm clip -> adam(1e-4)
    (constant LR: the reference's per-iteration optimizer re-creation never
    reaches the compiled update). aux_reward=True for training, plain env
    for eval, fixed reset keys — all as in apg.py:83-93,296-341.
  * IMPORTANTLY the physics, env semantics, reward, and goal data are the
    reference's own code and assets, imported from /root/reference.

Output: JSON lines with train/test reward and final chamfer, for
BASELINE.json `published.final_cost_*`.

Usage:
  python scripts/reference_baseline_run.py --env fold_cloth1 --max_it 1000
"""

import argparse
import json
import os
import sys
import time
import types

# ----------------------------------------------------------------- shims
import jax
import jax.numpy as jnp
import numpy as np
import optax

if not hasattr(jax.random, "KeyArray"):
    jax.random.KeyArray = jax.Array

_here = os.path.dirname(os.path.abspath(__file__))


def _stub(name, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    sys.modules.setdefault(name, mod)
    return mod


class _Anything:
    def __init__(self, *a, **k):
        pass

    def __call__(self, *a, **k):
        return self

    def __getattr__(self, _):
        return self

    def __getitem__(self, _):
        return self

    def __setitem__(self, *_):
        pass

    def __sub__(self, _):
        return 1.0

    def __rsub__(self, _):
        return 1.0

    def __mul__(self, _):
        return self

    def __rmul__(self, _):
        return self

    def __truediv__(self, _):
        return self

    def __rtruediv__(self, _):
        return 1.0

    def __imul__(self, _):
        return self


if "pyglet" not in sys.modules:
    pyglet = _stub("pyglet")
    pyglet.options = {}
class _AnyModule(types.ModuleType):
    def __getattr__(self, name):
        return _Anything()


def _stub_any(name):
    sys.modules.setdefault(name, _AnyModule(name))


for _m in ("pyrender", "trimesh"):
    _stub_any(_m)
_stub("pxr", Usd=_Anything(), UsdGeom=_Anything(), Gf=_Anything(),
      Sdf=_Anything(), Vt=_Anything())
_stub("open3d", io=_Anything(), geometry=_Anything(), utility=_Anything())
_stub("sdf", sdf3=_Anything(), box=_Anything(), sphere=_Anything())
_stub("wandb", init=_Anything(), log=_Anything(), config=_Anything())


class _Box:
    def __init__(self, low=None, high=None, shape=None, dtype=None):
        self.low, self.high, self.shape, self.dtype = low, high, shape, dtype


_gym = _stub("gym")
_gym.spaces = _stub("gym.spaces", Box=_Box)

sys.path.insert(0, "/root/reference/DaXBench")

# ------------------------------------------------------------ reference env
from daxbench.core.envs.fold_cloth1_env import FoldCloth1Env  # noqa: E402
from daxbench.core.envs.fold_cloth3_env import FoldCloth3Env  # noqa: E402
from daxbench.core.envs.whip_rope_env import WhipRopeEnv  # noqa: E402
from daxbench.core.utils.util import calc_chamfer, calc_l2  # noqa: E402

ENVS = {
    "fold_cloth1": FoldCloth1Env,
    "fold_cloth3": FoldCloth3Env,
    "whip_rope": WhipRopeEnv,
}
MPM_ENVS = {"whip_rope"}  # no sigmoid squash; auto_reset with fresh keys

# ------------------------------------------------- reference-equivalent APG
# (brax's make_direct_optimization_model is an MLP [512, 256, param_size]
# with swish; NormalTanhDistribution with min_std 0.001; see
# apg.py:353-358 and our models/ which were built to match.)
sys.path.insert(0, os.path.dirname(_here))
from unidom_tpu.models.distribution import NormalTanhDistribution  # noqa: E402
from unidom_tpu.models.mlp import make_policy_model  # noqa: E402


def apply_mpm_patches():
    """Shim patches any direct user of an MPM ENVS entry needs (main()
    applies them too): no-op the render-mesh path that feeds np.random a
    stubbed trimesh shape, float-ify PrimitiveState int leaves, and make
    tree_map/global_norm float0-tolerant (see inline comments)."""
    # MPMEnv.create_mesh_for_render feeds np.random.uniform a stubbed
    # trimesh shape (render-only path) — no-op it
    import daxbench.core.envs.basic.mpm_env as _mpm_mod

    _mpm_mod.MPMEnv.create_mesh_for_render = lambda self, size: None

    # PrimitiveState carries int leaves (dim=[3], min_dist=0,
    # dist_norm=0, primitives.py:32-55); modern jax hands their
    # cotangents to the reference's substep surrogate as float0 and the
    # tree_map multiply (mpm_simulator.py:353-355) raises. Same class
    # of issue as the int cloth stiffness: float dtypes restore the
    # original behavior without touching the math.
    _orig_cp = _mpm_mod.create_primitive

    def _float_cp(conf, friction, softness, color, size, init_pos):
        ps = _orig_cp(conf, friction=friction, softness=softness,
                      color=color, size=size, init_pos=init_pos)
        return jax.tree_util.tree_map(
            lambda l: l.astype(jnp.float32)
            if not jnp.issubdtype(l.dtype, jnp.floating) else l,
            ps,
        )

    _mpm_mod.create_primitive = _float_cp

    # The reference's gradient-stabilization custom-vjps tree_map
    # `nan_to_num(t + 0.0)` / `where(trigger, t, t/g_norm)` over whole
    # MPMState cotangents (mpm_simulator.py:390-394), which on modern
    # jax contain float0 leaves for the int state members (cur_step,
    # key). float0 IS the symbolic zero cotangent — passing it through
    # unchanged is exactly what the old zeros-array behavior computed.
    # Patch tree_map (process-wide, shim only) and optax.global_norm to
    # skip float0 leaves.
    from jax.dtypes import float0 as _f0

    _orig_tree_map = jax.tree_util.tree_map

    def _f0_safe_tree_map(f, tree, *rest, **kw):
        def safe_f(x, *r):
            if hasattr(x, "dtype") and x.dtype == _f0:
                return x
            return f(x, *r)

        return _orig_tree_map(safe_f, tree, *rest, **kw)

    jax.tree_util.tree_map = _f0_safe_tree_map
    jax.tree_map = _f0_safe_tree_map

    _orig_gn = optax.global_norm

    def _f0_safe_global_norm(updates):
        leaves = [
            x for x in jax.tree_util.tree_leaves(updates)
            if not (hasattr(x, "dtype") and x.dtype == _f0)
        ]
        return _orig_gn(leaves)

    optax.global_norm = _f0_safe_global_norm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="fold_cloth1", choices=sorted(ENVS))
    ap.add_argument("--num_envs", type=int, default=4)
    ap.add_argument("--ep_len", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--max_grad_norm", type=float, default=0.3)
    ap.add_argument("--max_it", type=int, default=1000)
    ap.add_argument("--eval_freq", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    # mem_saving_level=0: modern jax rejects the reference's custom_vjp
    # recompute wrappers (their allow_int grads emit float0 cotangents for
    # the int state leaves, which float0-intolerant tree ops then multiply).
    # The wrappers are exact-VJP rematerialization — level 0 computes the
    # SAME gradients via plain autodiff, just with more activation memory
    # (fine at 4 envs). conf comment in fold_cloth1_env.py:28-30 documents
    # the levels as memory knobs only.
    is_mpm = args.env in MPM_ENVS
    if is_mpm:
        apply_mpm_patches()
    if not is_mpm:
        # The reference's conf.stiffness is the Python int 900, so
        # state.stiffness traces as int32; on modern jax its cotangent is
        # float0 and the reference's own custom-vjp surrogate line
        # `nstate.stiffness * g.stiffness` (cloth_simulator.py:126) raises.
        # A float stiffness restores the original (float-cotangent)
        # behavior and keeps mem_saving_level=2, whose per-robot-step
        # recompute keeps the residuals small (level 0 tries to keep a
        # 50 GB f32[3,40,50,4,4096,3] residual buffer).
        import daxbench.core.envs.fold_cloth1_env as _m1
        import daxbench.core.envs.fold_cloth3_env as _m3

        for _m in (_m1, _m3):
            _m.DefaultConf.stiffness = float(_m.DefaultConf.stiffness)
            if os.environ.get("REF_MEM_LEVEL"):
                _m.DefaultConf.mem_saving_level = int(os.environ["REF_MEM_LEVEL"])

    kwargs = {"stiffness": 900.0} if args.env == "fold_cloth1" else {}
    env = ENVS[args.env](batch_size=args.num_envs, seed=args.seed,
                         aux_reward=True, **kwargs)
    eval_env = ENVS[args.env](batch_size=args.num_envs, seed=args.seed + 666,
                              **kwargs)

    dist = NormalTanhDistribution(event_size=env.action_size)
    model = make_policy_model(dist.param_size, env.observation_size)
    params = model.init(jax.random.PRNGKey(args.seed + 1))
    optimizer = optax.adam(learning_rate=args.lr)
    opt_state = optimizer.init(params)

    step_fn = env.step_diff
    eval_step_fn = eval_env.step_diff

    def _squash(a):
        # cloth (and ShapeRope) get the sigmoid; other MPM envs don't
        # (reference apg.py:185-186)
        return a if is_mpm else jax.nn.sigmoid(a)

    def do_one_step(carry, _):
        state, params, key = carry
        key, key_sample = jax.random.split(key)
        obs = env.get_obs(state)
        logits = model.apply(params, obs)
        actions = _squash(dist.sample(logits, key_sample))
        obs, reward, done, info = step_fn(actions, state)
        return (info["state"], params, key), (reward,)

    def loss(params, state, key):
        _, (reward_list,) = jax.lax.scan(
            do_one_step, (state, params, key), (), length=args.ep_len
        )
        return -jnp.mean(reward_list), reward_list

    loss_grad = jax.grad(loss, has_aux=True)

    def clip_by_global_norm(updates):
        g_norm = optax.global_norm(updates)
        trigger = g_norm < args.max_grad_norm
        return jax.tree_util.tree_map(
            lambda t: jnp.where(trigger, t, (t / g_norm) * args.max_grad_norm),
            updates,
        )

    @jax.jit
    def minimize(params, opt_state, state, key):
        grad_raw, reward_list = loss_grad(params, state, key)
        grad_raw = jax.tree_util.tree_map(jnp.nan_to_num, grad_raw)
        grad = clip_by_global_norm(grad_raw)
        updates, opt_state = optimizer.update(grad, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, reward_list, optax.global_norm(grad_raw)

    def do_one_step_eval(carry, _):
        state, params, key = carry
        key, key_sample = jax.random.split(key)
        obs = eval_env.get_obs(state)
        logits = model.apply(params, obs)
        actions = _squash(dist.sample(logits, key_sample))
        obs, reward, done, info = eval_step_fn(actions, state)
        return (info["state"], params, key), (reward,)

    @jax.jit
    def run_eval(params, state, key):
        # reference eval length = core_env.max_steps (apg.py:146):
        # 3 for the fold tasks, 70 for whip_rope
        (state, _, _), (reward_list,) = jax.lax.scan(
            do_one_step_eval, (state, params, key), (),
            length=eval_env.max_steps,
        )
        return state, reward_list

    # fixed reset keys, as the reference cloth training loop (apg.py:296-307);
    # env.reset(key) returns the full local batch (one shared shift). MPM
    # envs instead auto_reset with fresh per-env keys each iteration
    # (apg.py:300-307).
    key_env = jax.random.PRNGKey(args.seed)
    key_eval = jax.random.PRNGKey(args.seed + 666)
    _, first_state = env.reset(key_env)
    _, eval_first_state = eval_env.reset(key_eval)

    def train_first_state(it_key):
        if not is_mpm:
            return first_state
        keys = jax.random.split(it_key, args.num_envs)
        return env.auto_reset(first_state, first_state, keys)

    out = open(args.out, "a") if args.out else None
    key = jax.random.PRNGKey(args.seed + 2)
    t0 = time.time()
    final_chamfer = None
    for it in range(args.max_it + 1):
        if it % args.eval_freq == 0 or it == args.max_it:
            eval_state, eval_rewards = run_eval(params, eval_first_state, key_eval)
            test_reward = float(eval_rewards.sum(0).mean())
            cost = calc_l2 if is_mpm else calc_chamfer
            final_chamfer = float(cost(eval_state.x, eval_env.goal).mean())
            rec = {
                "it": it,
                "test_reward": test_reward,
                ("final_l2" if is_mpm else "final_chamfer"): final_chamfer,
                "walltime": time.time() - t0,
            }
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
        key, key_it = jax.random.split(key)
        key_env, key_reset = jax.random.split(key_env)
        params, opt_state, reward_list, gn = minimize(
            params, opt_state, train_first_state(key_reset), key_it
        )
        if it % args.eval_freq == 0:
            print(
                f"# it {it} train_reward {float(reward_list.sum(0).mean()):.4f} "
                f"grad_norm {float(gn):.4f} ({time.time() - t0:.0f}s)",
                flush=True,
            )
    if out:
        out.close()


if __name__ == "__main__":
    main()
