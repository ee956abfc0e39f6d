"""Bring-up smoke run of the APG training path on NVIDIA GPUs.

    python chip_smoke.py           # the one-card phases, in order:
                                   # device, cloth_apg, mpm_apg, train_entry,
                                   # bigrid, parity
    python chip_smoke.py --four    # the four-card data-parallel path and the
                                   # one-card run it is compared with, only

Every phase drives the normal entry points (``build_apg`` -> ``minimize``,
``algorithms.apg.train``) at the published widths: fold_cloth3 (N=80, 50
substeps, mem_saving_level=2) and whip_rope (n_grid 64, res 32^3, 70
substeps) at 1024 envs and ep_len 3; pour_soup (1M cells) and
shape_elasto_plastic (23,940 particles) at 2 envs and ep_len 1. Weights are
random from a fixed seed. No phase catches its own failure: any failure
exits non-zero and no result line is printed.

Without a GPU the ``device`` phase exits non-zero before anything else runs.
The last stdout line is the result,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
every measured number is printed on an earlier line beside the card's name
and power limit. The process is the only one that opens the cards; the
parity phase runs its CPU reference in the same process.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ONE_CARD_PHASES = ("device", "cloth_apg", "mpm_apg", "train_entry", "bigrid", "parity")
FOUR_CARD_PHASES = ("device", "four")

# Parity of the GPU against the host CPU backend, one simulator step
# (``step_batch``) in float32:
# max|dx| / max|x|, the relative error max|d| / max|ref| of v, C and F, and
# the cosine of the action gradients. v, C and F get the looser bound
# because tens of float32 substeps amplify reordered sums.
TOL_X = 1e-4
TOL_REL = 1e-2
TOL_COS = 0.99

# Sharded update vs the serial one-card recomputation: the per-shard clip
# comes before the pmean, and the all-reduce sums in another order, so the
# two are not bitwise equal. Adam's first step is -lr * g / (|g| + eps),
# about lr * sign(g): an entry whose gradient is at rounding level can flip
# sign and differ by 2 lr. So at most FOUR_MAX_MISMATCH of the entries may
# lie outside TOL_FOUR, and the two updates must point the same way.
TOL_FOUR = dict(rtol=1e-4, atol=1e-6)
FOUR_MAX_MISMATCH = 1e-3
FOUR_MIN_UPDATE_COS = 0.999

FULL = {
    "envs": 1024,  # bench batch of the one-card APG phases
    "ep_len": 3,
    "bigrid_envs": 2,
    "bigrid_ep_len": 1,
    "four_envs_per_card": 256,
    "train_eval_envs": 4,
}


# ---------------------------------------------------------------------- #
# pure helpers
# ---------------------------------------------------------------------- #


def parse_smi(text):
    """First line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` -> (name, power limit)."""
    lines = [l.strip() for l in text.splitlines() if l.strip()]
    if not lines or "," not in lines[0]:
        raise ValueError(f"unexpected nvidia-smi output: {text!r}")
    name, power = lines[0].rsplit(",", 1)
    return name.strip(), power.strip()


def final_line(platform, kind, count):
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def phases_for(four):
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def require_gpus(devices, n):
    """Exit non-zero unless JAX's first device is a GPU and at least ``n``
    GPUs are visible."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform {platform!r})")
    gpus = [d for d in devices if d.platform == "gpu"]
    if len(gpus) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, JAX found {len(gpus)}")


def rel_err(got, ref):
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def cosine(a, b):
    import numpy as np

    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# ---------------------------------------------------------------------- #
# run context
# ---------------------------------------------------------------------- #


class Run:
    """What the phases share: sizes, the card tag and the devices."""

    def __init__(self, sizes):
        self.sizes = sizes
        self.card = "card not read yet"
        self.devices = None

    def say(self, phase, msg):
        print(f"[{phase}] [{self.card}] {msg}", flush=True)

    def peak_bytes(self):
        """The card's peak since the process started: JAX cannot reset it,
        so a later phase reports the larger of its own and earlier peaks."""
        stats = self.devices[0].memory_stats() or {}
        return stats.get("peak_bytes_in_use")


def _leaves_equal(a, b):
    import jax
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(jax.device_get(a)),
        jax.tree_util.tree_leaves(jax.device_get(b))))


def _apg_env(task, batch_size):
    """The env exactly as ``train`` builds it (seed 0, aux reward on), so
    the train_entry phase reuses the compiled step."""
    import jax

    from unidom_tpu.envs.registration import env_functions

    env = env_functions[task](batch_size=batch_size, seed=0, aux_reward=True)
    if env.reset_mode in ("auto_reset", "host_reset"):
        env.reset(jax.random.PRNGKey(0))  # sizes the observation space
    return env


def _apg(run, phase, env, ep_len, mesh, n_warm, n_timed, must_learn=True):
    """Warm-up and timed ``minimize`` calls; each call ends by fetching a
    value to the host. Returns the median seconds per timed iteration, and
    the training state, batch and parameters after the first call."""
    import jax
    import numpy as np

    from unidom_tpu.algorithms.apg import build_apg

    init_ts, minimize, reset_batch, _ = build_apg(env, ep_len, mesh=mesh)
    ts0 = init_ts(0)
    state = reset_batch(jax.random.PRNGKey(0))
    num_envs = env.batch_size * mesh.devices.size

    ts = ts0
    t = time.time()
    for i in range(n_warm):  # minimize compiles twice (output shardings)
        ts, metrics = minimize(ts, state)
        float(metrics["reward"])
        if i == 0:
            params1 = ts.policy_params
    warm_s = time.time() - t
    times = []
    for _ in range(n_timed):
        t = time.time()
        ts, metrics = minimize(ts, state)
        float(metrics["reward"])
        times.append(time.time() - t)

    reward = float(metrics["reward"])
    grad_norm = float(metrics["grad_norm"])
    if not (np.isfinite(reward) and np.isfinite(grad_norm)):
        raise AssertionError(f"{phase}: reward {reward} grad_norm {grad_norm}")
    changed = not _leaves_equal(ts0.policy_params, ts.policy_params)
    if must_learn and not changed:
        raise AssertionError(f"{phase}: policy parameters did not change")
    msg = (f"{num_envs} envs ep_len {ep_len} on {mesh.devices.size} device(s): "
           f"warm-up {n_warm} call(s) {warm_s:.3f} s, reward {reward:.6g}, "
           f"grad_norm {grad_norm:.6g}, parameters changed {changed}")
    s_iter = None
    if times:
        s_iter = float(np.median(times))
        msg += (f", s/iter {s_iter:.4f} (runs {[round(x, 4) for x in times]}), "
                f"env-steps/s {ep_len * num_envs / s_iter:.1f}")
    run.say(phase, msg + f", peak_bytes_in_use {run.peak_bytes()} "
            "(process so far)")
    return s_iter, (minimize, ts0, state, params1)


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #


def phase_device(run, four):
    import jax

    devices = jax.devices()
    require_gpus(devices, 4 if four else 1)
    run.devices = devices
    import unidom_tpu

    # the program under test is the checkout this script sits in, never an
    # installed copy elsewhere
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.dirname(os.path.dirname(os.path.abspath(unidom_tpu.__file__))) != here:
        raise SystemExit(f"chip_smoke: unidom_tpu is not beside {here}")
    from unidom_tpu.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    name, power = parse_smi(smi)
    run.card = f"{name}, {power}"
    print(f"{name}, {power}", flush=True)
    run.say("device", f"device_kind {devices[0].device_kind!r}, "
            f"{len(devices)} device(s), jax {jax.__version__}")
    run.say("device", f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
            f"compilation cache {cache_dir}")


def phase_cloth_apg(run):
    from unidom_tpu.parallel.mesh import make_env_mesh

    env = _apg_env("fold_cloth3", run.sizes["envs"])
    _apg(run, "cloth_apg", env, run.sizes["ep_len"], make_env_mesh(1), 2, 3)


def phase_mpm_apg(run):
    from unidom_tpu.parallel.mesh import make_env_mesh

    env = _apg_env("whip_rope", run.sizes["envs"])
    _apg(run, "mpm_apg", env, run.sizes["ep_len"], make_env_mesh(1), 2, 3)


def phase_train_entry(run):
    import numpy as np

    from unidom_tpu.algorithms.apg import train

    max_it = 3
    with tempfile.TemporaryDirectory() as logdir:
        _, history = train(
            "fold_cloth3", episode_length=run.sizes["ep_len"],
            num_envs=run.sizes["envs"], max_it=max_it, seed=0,
            num_eval_envs=run.sizes["train_eval_envs"], num_devices=1,
            logdir=logdir,
        )
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            recs = [json.loads(l) for l in f]
        ckpts = sorted(p for p in os.listdir(logdir) if p.endswith(".pkl"))
    if len(recs) != max_it + 1 or not ckpts:
        raise AssertionError(f"train_entry: {len(recs)} records, ckpts {ckpts}")
    for r in recs:
        if not (np.isfinite(r["train_reward"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"train_entry: non-finite record {r}")
    run.say("train_entry", f"{len(recs)} iterations, checkpoints {ckpts}, "
            f"last train_reward {recs[-1]['train_reward']:.6g} grad_norm "
            f"{recs[-1]['grad_norm']:.6g} sps {recs[-1]['sps']:.1f}, "
            f"peak_bytes_in_use {run.peak_bytes()} (process so far)")


def phase_bigrid(run):
    from unidom_tpu.parallel.mesh import make_env_mesh

    for task in ("pour_soup", "shape_elasto_plastic"):
        env = _apg_env(task, run.sizes["bigrid_envs"])
        run.say("bigrid", f"{task}: res {env.conf.res}, "
                f"{env.simulator.n_particles} particles, "
                f"{env.conf.steps} substeps, transfer "
                f"{env.simulator.transfer_mode}")
        _apg(run, f"bigrid {task}", env, run.sizes["bigrid_ep_len"],
             make_env_mesh(1), 1, 0, must_learn=False)


def _loss_cot(s):
    """Fixed deterministic scalar whose action gradient is compared."""
    import jax.numpy as jnp

    w = jnp.sin(jnp.arange(s.x.size, dtype=jnp.float32).reshape(s.x.shape))
    return jnp.sum(s.x * w) + 0.1 * jnp.sum(s.v)


def _parity_case(task):
    """One macro step of ``task``'s simulator at B=1 (``step_batch``: one
    cloth robot step of 50 substeps, one MPM call of ``conf.steps``
    substeps): the compared state fields, ``step(state, action) -> state``,
    the reset state and the action."""
    import jax
    import jax.numpy as jnp

    from unidom_tpu.envs.registration import env_functions

    env = env_functions[task](batch_size=1, seed=0)
    _, state = env.reset(jax.random.PRNGKey(0))
    if task == "fold_cloth3":
        # gripper 0 on a corner particle, lifting and dragging it
        corner = state.x[0, 0, 0]
        state = state._replace(primitive0=state.primitive0.at[0, :3].set(corner))
        action = jnp.asarray([[0.1, 0.3, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0]])
        fields = ("x", "v")
    else:
        n_prim = len(state.primitives)
        action = jnp.full((1, 6 * n_prim), 0.03, jnp.float32)
        fields = ("x", "v", "C", "F", "J")

    def step(s, a):
        return env.simulator.step_batch(s, a)[0]

    return fields, step, state, action


def _parity_eval(fields, step, state, action, device):
    import jax

    state, action = jax.device_put((state, action), device)
    with jax.default_device(device):
        out = jax.jit(step)(state, action)
        grad = jax.jit(jax.grad(lambda a, s: _loss_cot(step(s, a))))(action, state)
    out = jax.device_get(out)
    return {k: getattr(out, k) for k in fields}, jax.device_get(grad)


def phase_parity(run):
    import jax
    import numpy as np

    gpu, cpu = run.devices[0], jax.devices("cpu")[0]
    failures = []
    for task in ("fold_cloth3", "whip_rope", "shape_elasto_plastic"):
        fields, step, state, action = _parity_case(task)
        ref, g_ref = _parity_eval(fields, step, state, action, cpu)
        for label, precision in (("default", None), ("highest", "highest")):
            if precision is None:
                got, g = _parity_eval(fields, step, state, action, gpu)
            else:
                with jax.default_matmul_precision(precision):
                    got, g = _parity_eval(fields, step, state, action, gpu)
            errs = {k: rel_err(got[k], ref[k]) for k in fields}
            cos = cosine(g, g_ref)
            finite = all(np.isfinite(v).all() for v in got.values())
            run.say("parity", f"{task} GPU {label} vs CPU: " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
                + f", grad cosine {cos:.6f}, grad norm gpu "
                f"{np.linalg.norm(g):.6g} cpu {np.linalg.norm(g_ref):.6g}")
            bad = [k for k in ("v", "C", "F") if k in errs and errs[k] > TOL_REL]
            if errs["x"] > TOL_X:
                bad.insert(0, "x")
            if not (cos >= TOL_COS):
                bad.append("grad cosine")
            if not finite:
                bad.append("non-finite state")
            if bad:
                failures.append(f"{task} {label}: {bad}")
    if failures:
        raise AssertionError(f"parity outside tolerance: {failures}")


def phase_four(run):
    """Sharded minimize over 4 cards vs the serial one-card recomputation
    of the same update, then s/iter on 4 cards and on 1 card at the same
    per-card batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from unidom_tpu.ops.gradops import global_norm_clip
    from unidom_tpu.parallel.mesh import make_env_mesh

    per_card = run.sizes["four_envs_per_card"]
    ep_len = run.sizes["ep_len"]
    mesh4, mesh1 = make_env_mesh(4), make_env_mesh(1)
    for task in ("fold_cloth3", "whip_rope"):
        env = _apg_env(task, per_card)
        s4, (minimize, ts, state, got) = _apg(
            run, f"four {task} 4 cards", env, ep_len, mesh4, 2, 3)
        s1, _ = _apg(run, f"four {task} 1 card", env, ep_len, mesh1, 2, 3)

        dbg = minimize.debug
        loss_grad = jax.jit(dbg["loss_grad"])
        _, key_grad = jax.random.split(ts.key)
        one = run.devices[0]
        params, norm_params, key_grad = jax.device_put(
            (ts.policy_params, ts.normalizer_params, key_grad), one)
        grads = []
        for d in range(4):
            shard = jax.device_put(jax.tree_util.tree_map(
                lambda x: x[d * per_card:(d + 1) * per_card], state), one)
            g, _ = loss_grad(params, norm_params, shard, key_grad)
            g = jax.tree_util.tree_map(jnp.nan_to_num, g)
            grads.append(global_norm_clip(g, dbg["max_gradient_norm"]))
        grad = jax.tree_util.tree_map(lambda *gs: sum(gs) / len(gs), *grads)
        update, _ = dbg["optimizer"].update(
            grad, jax.device_put(ts.optimizer_state, one))
        expected = jax.device_get(optax.apply_updates(params, update))
        flat = [np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(t))]).astype(np.float64) for t in (got, expected, params)]
        got, expected, before = flat
        outside = np.abs(got - expected) > (
            TOL_FOUR["atol"] + TOL_FOUR["rtol"] * np.abs(expected))
        frac = float(outside.mean())
        cos = cosine(got - before, expected - before)
        worst = float(np.abs(got - expected).max())
        run.say("four", f"{task}: 4-card update vs serial one-card "
                f"recomputation: {int(outside.sum())} of {got.size} entries "
                f"outside rtol {TOL_FOUR['rtol']} atol {TOL_FOUR['atol']} "
                f"(limit {FOUR_MAX_MISMATCH:g} of them), update cosine "
                f"{cos:.6f} (limit {FOUR_MIN_UPDATE_COS}), worst absolute "
                f"difference {worst:.3e}")
        if frac > FOUR_MAX_MISMATCH or not cos >= FOUR_MIN_UPDATE_COS:
            raise AssertionError(f"four {task}: sharded update disagrees "
                                 f"with the serial recomputation")
        run.say("four", f"{task}: {per_card} envs per card, s/iter 4 cards "
                f"{s4:.4f} vs 1 card {s1:.4f}, scaling efficiency "
                f"{s1 / s4:.3f}")


def run_phases(run, phases, four=False):
    for name in phases:
        t = time.time()
        if name == "device":
            phase_device(run, four)
        else:
            globals()[f"phase_{name}"](run)
        run.say(name, f"phase wall time {time.time() - t:.1f} s")


def _keep_cpu_backend():
    """The parity phase needs the host CPU backend beside the GPU: where
    JAX_PLATFORMS names platforms, make sure cpu is among them. Must run
    before jax is imported."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel path")
    args = ap.parse_args(argv)

    _keep_cpu_backend()
    run = Run(FULL)
    t0 = time.time()
    run_phases(run, phases_for(args.four), four=args.four)
    run.say("total", f"wall time {time.time() - t0:.1f} s")
    d = run.devices[0]
    print(final_line(d.platform, d.device_kind, len(run.devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
