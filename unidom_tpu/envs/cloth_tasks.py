"""Concrete cloth task environments.

Reference parity targets:
- fold_cloth1 / fold_cloth1_para (fold_cloth1_env.py:15-53,
  fold_cloth1_para_env.py:15-53): 16x32 rectangle on an 80-grid, 3 macro
  steps, ctor-selectable stiffness.
- fold_cloth3 (fold_cloth3_env.py): same cloth, 4 macro steps.
- unfold_cloth1 / unfold_cloth3 (unfold_cloth{1,3}_env.py): random-folded
  reset via 1 / 3 scripted step_diff folds, 15 macro steps, mu=3.
- fold_tshirt (fold_cloth_tshirt_env.py:19-72): N=180, stiffness 5000,
  dt=0.5e-3, mask from a t-shirt silhouette. We synthesize the silhouette
  procedurally instead of thresholding a JPEG (no cv2 dependency; same
  mask resolution/placement contract).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from unidom_tpu.engine.cloth import ClothConf
from unidom_tpu.envs.base_cloth import ClothEnv

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def _goal(task):
    return os.path.join(ASSET_DIR, "goals", task, "goal.npy")


def _rect_mask(N, size):
    mask = np.zeros((N, N), dtype=np.float32)
    mask[size * 2 : size * 3, size * 2 : size * 4] = 1.0
    return mask  # numpy: the simulator builds its topology on the host


class FoldCloth1Env(ClothEnv):
    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, stiffness=900, **kwargs):
        conf = conf or ClothConf(task="fold_cloth1", goal_path=_goal("fold_cloth1"), seed=seed)
        conf.stiffness = stiffness
        super().__init__(conf, batch_size, max_steps=3, aux_reward=aux_reward,
                         obs_type=kwargs.get("obs_type", "PARTICLE"))

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)


class FoldCloth1ParaEnv(ClothEnv):
    """Stiffness-conditioned observation variant (the GenORM 'para' capability)."""

    def __init__(
        self,
        batch_size,
        conf=None,
        aux_reward=False,
        seed=1,
        stiffness=900,
        eval_min_max_stiff=(100.0, 2000.0),
        **kwargs,
    ):
        conf = conf or ClothConf(task="fold_cloth1", goal_path=_goal("fold_cloth1"), seed=seed)
        conf.stiffness = stiffness
        super().__init__(
            conf,
            batch_size,
            max_steps=3,
            aux_reward=aux_reward,
            param_obs=True,
            eval_min_max_stiff=eval_min_max_stiff,
            obs_type=kwargs.get("obs_type", "PARTICLE"),
        )

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)


class FoldCloth3Env(ClothEnv):
    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, **kwargs):
        conf = conf or ClothConf(task="fold_cloth3", goal_path=_goal("fold_cloth3"), seed=seed)
        super().__init__(conf, batch_size, max_steps=4, aux_reward=aux_reward,
                         obs_type=kwargs.get("obs_type", "PARTICLE"))

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)


class _UnfoldClothEnv(ClothEnv):
    """Shared unfold implementation: reset applies ``n_folds`` random scripted
    folds through the differentiable step itself (unfold_cloth3_env.py:56-80)."""

    N_FOLDS = 3

    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, **kwargs):
        task = f"unfold_cloth{self.N_FOLDS}"
        conf = conf or ClothConf(
            task=task, goal_path=_goal(task), mu=3.0, use_substep_obs=False, seed=seed
        )
        super().__init__(conf, batch_size, max_steps=15, aux_reward=aux_reward,
                         obs_type=kwargs.get("obs_type", "PARTICLE"))

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)

    def random_fold(self, state, step):
        for _ in range(step):
            actions = self.get_random_fold_action(state)
            _, _, _, info = self.step_diff(actions, state)
            state = info["state"]
        return state

    def build_reset(self):
        init_state = self.simulator.reset()

        def reset(key):
            key, _ = jax.random.split(key)
            new_x = init_state.x + jax.random.normal(key, init_state.x.shape) * 0.0001
            state = init_state._replace(x=new_x)
            state = self.random_fold(state, step=self.N_FOLDS)
            # folding advanced cur_step; episodes start fresh
            state = state._replace(cur_step=jnp.zeros_like(state.cur_step))
            return self.get_obs(state), state

        return reset


class UnfoldCloth1Env(_UnfoldClothEnv):
    N_FOLDS = 1


class UnfoldCloth3Env(_UnfoldClothEnv):
    N_FOLDS = 3


def _tshirt_mask(N):
    """The reference's t-shirt mask (fold_cloth_tshirt_env.py:51-71),
    adopted from its t-shirt.jpg via scripts/adopt_assets.py (cv2-exact
    resize + rotate + threshold; 3573 particles = the recorded goal cloud's
    row count). Falls back to a procedural silhouette only if the adopted
    asset is missing (non-reference N)."""
    asset = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "tshirt_mask.npy")
    if N == 180 and os.path.exists(asset):
        return np.load(asset).astype(np.float32)

    size = N // 2
    h_size = size // 2
    m = np.zeros((size, size), dtype=np.float32)

    body_w = int(size * 0.44)
    body_h = int(size * 0.62)
    bx0 = (size - body_w) // 2
    by0 = int(size * 0.22)
    m[by0 : by0 + body_h, bx0 : bx0 + body_w] = 1.0

    sleeve_h = int(size * 0.2)
    sleeve_w = int(size * 0.22)
    m[by0 : by0 + sleeve_h, bx0 - sleeve_w : bx0] = 1.0
    m[by0 : by0 + sleeve_h, bx0 + body_w : bx0 + body_w + sleeve_w] = 1.0

    neck_w = int(size * 0.12)
    nx0 = (size - neck_w) // 2
    m[by0 : by0 + int(size * 0.04), nx0 : nx0 + neck_w] = 0.0

    m = m.T[::-1]  # rotate 90 deg clockwise, as the reference does
    mask = np.zeros((N, N), dtype=np.float32)
    c = N // 2
    mask[c - h_size : c + h_size, c - h_size : c + h_size] = m
    return mask  # numpy: the simulator builds its topology on the host


class FoldTshirtEnv(ClothEnv):
    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, **kwargs):
        conf = conf or ClothConf(
            N=180,
            stiffness=5000.0,
            dt=0.5e-3,
            mu=0.9,
            task="fold_tshirt",
            goal_path=_goal("fold_tshirt"),
            seed=seed,
        )
        super().__init__(conf, batch_size, max_steps=5, aux_reward=aux_reward,
                         obs_type=kwargs.get("obs_type", "PARTICLE"))

    def create_cloth_mask(self, conf):
        return _tshirt_mask(conf.N)
