"""K-FAC preconditioner (ACKTR) for PolicyMLP parameter trees.

Reference: GenORM/policy/pbm/plb/algorithms/ppo/ppo/algo/kfac.py:87-243 and
its use in a2c_acktr.py (ACKTR = natural-gradient A2C/PPO). Semantics kept:

- per-Dense-layer Fisher blocks: A = E[a a^T] over layer *inputs*,
  G = B * E[g g^T] over pre-activation output grads of a *sampled* Fisher
  loss (kfac.py:29-64 cov scaling), bias treated as its own block with
  A = [[1]] (the SplitBias/AddBias construction, kfac.py:73-108);
- running stats: m <- m * stat_decay + cov * (1 - stat_decay), initialized
  with the first batch (kfac.py:152-177);
- eigendecomposed preconditioning every Tf steps with eigenvalue floor 1e-6
  and damping: v = Q_g (Q_g^T dW Q_a / (d_g d_a^T + damping)) Q_a^T
  (kfac.py:196-228);
- trust-region rescale nu = min(1, sqrt(kl_clip / sum(v * g * lr^2)))
  (kfac.py:229-239), then SGD with momentum at lr * (1 - momentum)
  (kfac.py:139-143).

Design deltas: no module hooks — layer inputs come from an explicit
forward and pre-activation cotangents from ``jax.grad`` w.r.t. zero "taps"
added to each pre-activation (exact autodiff, no hand-rolled backprop); the
whole update is one jitted function over NamedTuple state.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax


def _dense_names(params):
    p = params["params"]
    return sorted((k for k in p if k.startswith("dense_")),
                  key=lambda s: int(s.split("_")[-1]))


def _forward_saved(params, x):
    """Forward pass of PolicyMLP saving each Dense layer's input."""
    p = params["params"]
    names = _dense_names(params)
    a, acts = x, []
    for i, n in enumerate(names):
        acts.append(a)
        z = a @ p[n]["kernel"] + p[n]["bias"]
        a = jax.nn.swish(z) if i < len(names) - 1 else z
    return a, acts


def _cotangents(params, x, loss_of_logits):
    """Grad of the Fisher loss w.r.t. each layer's pre-activation (B, out)."""
    p = params["params"]
    names = _dense_names(params)

    def f(taps):
        a = x
        for i, n in enumerate(names):
            z = a @ p[n]["kernel"] + p[n]["bias"] + taps[i]
            a = jax.nn.swish(z) if i < len(names) - 1 else z
        return loss_of_logits(a)

    taps = [jnp.zeros((x.shape[0], p[n]["bias"].shape[0])) for n in names]
    return jax.grad(f)(taps)


class KFACLayerState(NamedTuple):
    m_aa: jnp.ndarray  # (in, in)
    m_gg: jnp.ndarray  # (out, out)
    q_a: jnp.ndarray
    d_a: jnp.ndarray
    q_g: jnp.ndarray
    d_g: jnp.ndarray


class KFACState(NamedTuple):
    steps: jnp.ndarray
    layers: dict  # net name -> tuple of KFACLayerState
    sgd: optax.OptState


class KFAC:
    """K-FAC over one or more PolicyMLP parameter trees.

    nets: {name: params_template}; update() takes matching {name: (x, fisher
    loss fn)} stat inputs plus the regular gradient tree.
    """

    def __init__(self, lr=0.25, momentum=0.9, stat_decay=0.99, kl_clip=1e-3,
                 damping=1e-2, weight_decay=0.0, Tf=10):
        self.lr = lr
        self.momentum = momentum
        self.stat_decay = stat_decay
        self.kl_clip = kl_clip
        self.damping = damping
        self.weight_decay = weight_decay
        self.Tf = Tf
        self.sgd = optax.sgd(learning_rate=lr * (1 - momentum), momentum=momentum)

    def init(self, nets_params):
        layers = {}
        for name, params in nets_params.items():
            p = params["params"]
            states = []
            for n in _dense_names(params):
                din, dout = p[n]["kernel"].shape
                states.append(KFACLayerState(
                    m_aa=jnp.eye(din), m_gg=jnp.eye(dout),
                    q_a=jnp.eye(din), d_a=jnp.ones((din,)),
                    q_g=jnp.eye(dout), d_g=jnp.ones((dout,)),
                ))
            layers[name] = tuple(states)
        return KFACState(steps=jnp.zeros((), jnp.int32), layers=layers,
                         sgd=self.sgd.init(nets_params))

    # ------------------------------------------------------------ #

    def _update_stats(self, state, nets_params, stat_inputs):
        new_layers = {}
        first = state.steps == 0
        for name, params in nets_params.items():
            x, fisher_loss = stat_inputs[name]
            B = x.shape[0]
            _, acts = _forward_saved(params, x)
            gs = _cotangents(params, x, fisher_loss)
            states = []
            for a, g, ls in zip(acts, gs, state.layers[name]):
                aa = a.T @ (a / B)  # kfac.py:46 (Linear)
                g_ = g * B
                gg = g_.T @ (g_ / B)  # kfac.py:63
                m_aa = jnp.where(first, aa,
                                 ls.m_aa * self.stat_decay + aa * (1 - self.stat_decay))
                m_gg = jnp.where(first, gg,
                                 ls.m_gg * self.stat_decay + gg * (1 - self.stat_decay))
                states.append(ls._replace(m_aa=m_aa, m_gg=m_gg))
            new_layers[name] = tuple(states)
        return state._replace(layers=new_layers)

    def _update_eigs(self, state):
        def recompute(layers):
            out = {}
            for name, states in layers.items():
                new = []
                for ls in states:
                    d_a, q_a = jnp.linalg.eigh(ls.m_aa)
                    d_g, q_g = jnp.linalg.eigh(ls.m_gg)
                    d_a = d_a * (d_a > 1e-6)
                    d_g = d_g * (d_g > 1e-6)
                    new.append(ls._replace(q_a=q_a, d_a=d_a, q_g=q_g, d_g=d_g))
                out[name] = tuple(new)
            return out

        layers = jax.lax.cond(
            state.steps % self.Tf == 0,
            recompute,
            lambda l: l,
            state.layers,
        )
        return state._replace(layers=layers)

    def _precondition(self, state, grads):
        la = self.damping + self.weight_decay
        out = {}
        vg_sum = 0.0
        for name, g_tree in grads.items():
            gp = g_tree["params"]
            new_gp = {}
            for i, n in enumerate(_dense_names(g_tree)):
                ls = state.layers[name][i]
                gw = gp[n]["kernel"].T  # (out, in) like torch
                v1 = ls.q_g.T @ gw @ ls.q_a
                v2 = v1 / (ls.d_g[:, None] * ls.d_a[None, :] + la)
                vw = (ls.q_g @ v2 @ ls.q_a.T).T  # back to (in, out)
                gb = gp[n]["bias"]
                # bias block: A = [[1]] (AddBias), so only G preconditioned
                vb = ls.q_g @ ((ls.q_g.T @ gb) / (ls.d_g + la))
                vg_sum = vg_sum + (vw * gp[n]["kernel"]).sum() * self.lr**2
                vg_sum = vg_sum + (vb * gb).sum() * self.lr**2
                new_gp[n] = {"kernel": vw, "bias": vb}
            out[name] = {"params": new_gp}

        nu = jnp.minimum(1.0, jnp.sqrt(self.kl_clip / (vg_sum + 1e-12)))
        return jax.tree_util.tree_map(lambda v: v * nu, out)

    # ------------------------------------------------------------ #

    def update(self, state: KFACState, nets_params, grads, stat_inputs):
        """One ACKTR step. Returns (new_params, new_state)."""
        if self.weight_decay > 0:
            grads = jax.tree_util.tree_map(
                lambda g, p: g + self.weight_decay * p, grads, nets_params
            )
        state = self._update_stats(state, nets_params, stat_inputs)
        state = self._update_eigs(state)
        nat_grads = self._precondition(state, grads)
        updates, sgd_state = self.sgd.update(nat_grads, state.sgd)
        new_params = optax.apply_updates(nets_params, updates)
        return new_params, state._replace(steps=state.steps + 1, sgd=sgd_state)
