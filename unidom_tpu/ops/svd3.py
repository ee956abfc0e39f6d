"""Batched 3x3 SVD with a degenerate-safe custom VJP.

The forward pass is a one-sided Jacobi eigendecomposition of ``A^T A`` —
fused element-wise sweeps that vectorize across the particle batch, with no
per-matrix control flow. This replaces the LAPACK-style ``jnp.linalg.svd`` the reference calls
on GPU (reference: DaXBench/daxbench/core/engine/svd_safe_batch.py:19-51).

The backward pass implements the standard complex-safe SVD adjoint with
``x -> x / (x^2 + eps)`` regularized inverses so gradients stay finite when
singular values collide or vanish (same math as svd_safe_batch.py:54-102,
re-derived).

Both passes run in **component form** (ops/m3.py): a matrix batch is nine
flat arrays, every 3x3 matmul is 27 fused multiply-adds, and each Jacobi
rotation updates components with two scalars — so the whole SVD compiles to
a handful of element-wise loops instead of thousands of
(..., 3, 3) micro-matmuls. ``svd3``/``svd3_jacobi`` keep the AoS
``(..., 3, 3)`` interface (converting at the boundary); ``svd3_soa`` is the
native component-form entry point for SoA callers.
"""

from functools import partial

import jax
import jax.numpy as jnp

from unidom_tpu.ops import m3

DEFAULT_EPS = 1e-12
_JACOBI_SWEEPS = 6  # full sweeps of the 3 off-diagonal rotations


def _jacobi_rotation(app, aqq, apq):
    """Stable Givens rotation (c, s) that annihilates ``apq``."""
    # tau = (aqq - app) / (2 apq); t = sign(tau)/(|tau| + sqrt(1+tau^2))
    safe_apq = jnp.where(jnp.abs(apq) < 1e-30, 1.0, apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(jnp.abs(apq) < 1e-30, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    return c, s


def _apply_jacobi(S, V, p, q):
    """One (p, q) rotation: S <- G^T S G, V <- V G, in component form.
    G is identity except G[p,p]=G[q,q]=c, G[p,q]=s, G[q,p]=-s, so the
    update mixes rows then columns p and q of S, and columns p, q of V."""
    c, s = _jacobi_rotation(S[p][p], S[q][q], S[p][q])
    S = [list(row) for row in S]
    # rows: row_p' = c row_p - s row_q ; row_q' = s row_p + c row_q
    for j in range(3):
        rp, rq = S[p][j], S[q][j]
        S[p][j] = c * rp - s * rq
        S[q][j] = s * rp + c * rq
    # columns: col_p' = c col_p - s col_q ; col_q' = s col_p + c col_q
    for i in range(3):
        cp, cq = S[i][p], S[i][q]
        S[i][p] = c * cp - s * cq
        S[i][q] = s * cp + c * cq
    V = [list(row) for row in V]
    for i in range(3):
        vp, vq = V[i][p], V[i][q]
        V[i][p] = c * vp - s * vq
        V[i][q] = s * vp + c * vq
    return tuple(tuple(r) for r in S), tuple(tuple(r) for r in V)


def _eigh3_soa(M):
    """Cyclic-Jacobi eigendecomposition of symmetric 3x3 batches in
    component form. Returns (w, V) with ``M ~= V diag(w) V^T``.

    The sweep loop is a ``fori_loop`` rather than a Python unroll: this
    sits inside every physics substep, and a rolled loop keeps the compiled
    substep small; it is never reverse-differentiated through because
    ``svd3_soa``/``svd3`` carry a custom VJP."""

    def sweep(_, SV):
        S, V = SV
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            S, V = _apply_jacobi(S, V, p, q)
        return S, V

    S, V = jax.lax.fori_loop(
        0, _JACOBI_SWEEPS, sweep, (M, m3.eye_like(M[0][0]))
    )
    return m3.diag(S), V


def _sort_desc_soa(sig, V):
    """Descending 3-sort of singular values + matching V columns via a
    compare-exchange network (no argsort/gather — stays element-wise)."""
    sig = list(sig)
    V = [list(row) for row in V]

    def cswap(a, b):
        swap = sig[a] < sig[b]
        sig[a], sig[b] = (
            jnp.where(swap, sig[b], sig[a]),
            jnp.where(swap, sig[a], sig[b]),
        )
        for i in range(3):
            va, vb = V[i][a], V[i][b]
            V[i][a] = jnp.where(swap, vb, va)
            V[i][b] = jnp.where(swap, va, vb)

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    return tuple(sig), tuple(tuple(r) for r in V)


def _norm3(v):
    return jnp.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def svd3_soa_fwd(A):
    """Component-form forward SVD: A (nested 3x3 tuple of arrays) ->
    (U, sig, V) with ``A == U diag(sig) V^T``; sig non-negative, sorted
    descending; U orthogonal (may contain a reflection when det(A) < 0,
    matching LAPACK convention)."""
    ATA = m3.matmul_tn(A, A)
    w, V = _eigh3_soa(ATA)
    sig = tuple(jnp.sqrt(jnp.maximum(wi, 0.0)) for wi in w)
    sig, V = _sort_desc_soa(sig, V)

    # U = A V / sig, regularized for tiny singular values, then
    # re-orthonormalized by modified Gram-Schmidt with deterministic
    # fallbacks so degenerate columns stay orthogonal.
    AV = m3.matmul(A, V)
    safe = tuple(s / (s * s + 1e-30) for s in sig)
    U = m3.scale_cols(AV, safe)

    one = jnp.ones_like(sig[0])
    zero = jnp.zeros_like(sig[0])
    e0 = (one, zero, zero)

    def normalize(col, fallback):
        n = _norm3(col)
        ok = n > 1e-6
        nsafe = jnp.where(ok, n, 1.0)
        return tuple(
            jnp.where(ok, ci / nsafe, fi) for ci, fi in zip(col, fallback)
        )

    u0 = normalize(m3.col(U, 0), e0)
    c1 = m3.col(U, 1)
    d = m3.dot3(c1, u0)
    u1 = tuple(c1i - d * u0i for c1i, u0i in zip(c1, u0))
    # fallback for u1: any vector orthogonal to u0
    rolled = (u0[2] + 0.5, u0[0], u0[1])  # roll(u0, 1) + e0 * 0.5
    alt = m3.cross3(u0, rolled)
    altn_den = jnp.maximum(_norm3(alt), 1e-12)
    altn = tuple(a / altn_den for a in alt)
    u1 = normalize(u1, altn)
    u2 = m3.cross3(u0, u1)
    # keep the sign consistent with A V when sigma_2 is meaningful
    av2 = m3.col(AV, 2)
    sgn = jnp.sign(m3.dot3(u2, av2))
    sgn = jnp.where(jnp.abs(sgn) < 0.5, 1.0, sgn)
    u2 = tuple(u2i * sgn for u2i in u2)

    U = tuple((u0[i], u1[i], u2[i]) for i in range(3))  # columns u0, u1, u2
    return U, sig, V


def _safe_inverse(x, eps):
    return x / (x * x + eps)


def svd3_soa_bwd(epsilon, res, g):
    """Component-form degenerate-safe SVD adjoint. ``res = (U, sig, V)``;
    ``g = (dU, dsig, dV)``; returns dA (all nested tuples)."""
    U, S, V = res
    dU, dS, dV = g

    UtdU = m3.matmul_tn(U, dU)
    VtdV = m3.matmul_tn(V, dV)

    S2 = tuple(s * s for s in S)
    S_inv = tuple(_safe_inverse(s, epsilon) for s in S)

    # F[i][j] = safe_inv(S2[j] - S2[i]) off-diagonal, 0 on the diagonal
    zero = jnp.zeros_like(S[0])
    Fm = tuple(
        tuple(
            zero if i == j else _safe_inverse(S2[j] - S2[i], epsilon)
            for j in range(3)
        )
        for i in range(3)
    )

    J = m3.hadamard(Fm, UtdU)
    K = m3.hadamard(Fm, VtdV)
    # L = I * VtdV is diagonal, so the reference's (L - L^T) term vanishes
    # identically in the real case (svd_safe_batch.py:87 keeps it for the
    # complex-safe general formula); we drop the zero term.

    JJt = m3.add(J, m3.transpose(J))
    KKt = m3.add(K, m3.transpose(K))

    Vh = m3.transpose(V)
    # term 1: (U * dS) @ Vh
    dA = m3.matmul(m3.scale_cols(U, dS), Vh)
    # term 2: U @ ((J + J^T) * S_row) @ Vh  — S broadcast over columns
    dA = m3.add(dA, m3.matmul(U, m3.matmul(m3.scale_cols(JJt, S), Vh)))
    # term 3: (U * S) @ (K + K^T) @ Vh
    dA = m3.add(dA, m3.matmul(m3.scale_cols(U, S), m3.matmul(KKt, Vh)))
    # term 4: (I - U U^T) @ (dU * S_inv) @ Vh
    PU = m3.sub(m3.eye_like(S[0]), m3.matmul_nt(U, U))
    dA = m3.add(dA, m3.matmul(PU, m3.matmul(m3.scale_cols(dU, S_inv), Vh)))
    # term 5: (U * S_inv) @ dV^T @ (I - V V^T)
    PV = m3.sub(m3.eye_like(S[0]), m3.matmul_nt(V, V))
    dA = m3.add(
        dA,
        m3.matmul(m3.scale_cols(U, S_inv), m3.matmul(m3.transpose(dV), PV)),
    )
    return dA


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def svd3_soa(A, epsilon=DEFAULT_EPS):
    """Component-form 3x3 batched SVD with the degenerate-safe VJP.
    ``A`` is a nested 3x3 tuple of arrays; returns (U, sig, V) — note V,
    not V^T, to keep the SoA call sites transpose-free."""
    return svd3_soa_fwd(A)


def _svd3_soa_fwd(A, epsilon):
    out = svd3_soa_fwd(A)
    return out, out


def _svd3_soa_bwd(epsilon, res, g):
    return (svd3_soa_bwd(epsilon, res, g),)


svd3_soa.defvjp(_svd3_soa_fwd, _svd3_soa_bwd)


# ---------------------------------------------------------------------- #
# AoS (..., 3, 3) interface
# ---------------------------------------------------------------------- #


def svd3_jacobi(A):
    """Forward 3x3 SVD: ``A == (U * S[..., None, :]) @ Vh``.

    S is non-negative, sorted descending. U, Vh orthogonal (U may contain a
    reflection when A has negative determinant, matching LAPACK convention
    where S stays non-negative).
    """
    U, sig, V = svd3_soa_fwd(m3.from_aos(A))
    return m3.to_aos(U), jnp.stack(sig, axis=-1), m3.to_aos(m3.transpose(V))


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def svd3(A, epsilon=DEFAULT_EPS):
    """3x3 batched SVD with a degenerate-safe VJP (drop-in for the hot path)."""
    return svd3_jacobi(A)


def _svd3_fwd(A, epsilon):
    U, S, Vh = svd3_jacobi(A)
    return (U, S, Vh), (U, S, Vh)


def _svd3_bwd(epsilon, res, g):
    U, S, Vh = res
    dU, dS, dVh = g
    res_soa = (
        m3.from_aos(U),
        tuple(S[..., i] for i in range(3)),
        m3.transpose(m3.from_aos(Vh)),
    )
    g_soa = (
        m3.from_aos(dU),
        tuple(dS[..., i] for i in range(3)),
        m3.transpose(m3.from_aos(dVh)),
    )
    return (m3.to_aos(svd3_soa_bwd(epsilon, res_soa, g_soa)),)


svd3.defvjp(_svd3_fwd, _svd3_bwd)
