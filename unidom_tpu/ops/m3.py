"""Component-form ("structure-of-arrays") batched 3x3 linear algebra.

A batch of 3x3 matrices is a 3x3 nested tuple of identically-shaped arrays
(``M[i][j]`` is the (i, j) component across the whole batch); a batch of
3-vectors is a 3-tuple. Every op below unrolls to fused element-wise
multiply-adds over the flat batch axis.

Why this exists: the AoS ``(..., 3, 3)`` layout the reference uses
(svd_safe_batch.py, mpm_simulator.py stress math) puts a 3-wide axis
minormost and lowers each 3x3 matmul to a tiny degenerate dot. In component
form the minormost axis is the particle batch, memory accesses are
contiguous across particles, and XLA fuses whole chains of these ops into
single element-wise loops.
"""

import jax.numpy as jnp


def from_aos(A):
    """(..., 3, 3) array -> nested tuple of 9 (...) arrays."""
    return tuple(tuple(A[..., i, j] for j in range(3)) for i in range(3))


def to_aos(M):
    """Nested tuple -> (..., 3, 3) array."""
    return jnp.stack([jnp.stack(row, axis=-1) for row in M], axis=-2)


def eye_like(x):
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    return tuple(
        tuple(one if i == j else zero for j in range(3)) for i in range(3)
    )


def zeros_like(x):
    zero = jnp.zeros_like(x)
    return tuple(tuple(zero for _ in range(3)) for _ in range(3))


def transpose(M):
    return tuple(tuple(M[j][i] for j in range(3)) for i in range(3))


def add(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3))


def sub(A, B):
    return tuple(tuple(A[i][j] - B[i][j] for j in range(3)) for i in range(3))


def scale(A, s):
    return tuple(tuple(A[i][j] * s for j in range(3)) for i in range(3))


def hadamard(A, B):
    return tuple(tuple(A[i][j] * B[i][j] for j in range(3)) for i in range(3))


def matmul(A, B):
    """C = A @ B, unrolled: 27 fused multiply-adds."""
    return tuple(
        tuple(
            A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j]
            for j in range(3)
        )
        for i in range(3)
    )


def matmul_tn(A, B):
    """C = A^T @ B."""
    return tuple(
        tuple(
            A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j]
            for j in range(3)
        )
        for i in range(3)
    )


def matmul_nt(A, B):
    """C = A @ B^T."""
    return tuple(
        tuple(
            A[i][0] * B[j][0] + A[i][1] * B[j][1] + A[i][2] * B[j][2]
            for j in range(3)
        )
        for i in range(3)
    )


def matvec(A, v):
    return tuple(
        A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2] for i in range(3)
    )


def col(M, j):
    return (M[0][j], M[1][j], M[2][j])


def with_col(M, j, v):
    return tuple(
        tuple(v[i] if jj == j else M[i][jj] for jj in range(3)) for i in range(3)
    )


def scale_cols(M, s):
    """M @ diag(s): column j scaled by s[j]."""
    return tuple(tuple(M[i][j] * s[j] for j in range(3)) for i in range(3))


def diag(M):
    return (M[0][0], M[1][1], M[2][2])


def trace(M):
    return M[0][0] + M[1][1] + M[2][2]


def det(M):
    return (
        M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1])
        - M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0])
        + M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0])
    )


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def where(mask, A, B):
    """Component-wise select with a batch-shaped boolean mask."""
    return tuple(
        tuple(jnp.where(mask, A[i][j], B[i][j]) for j in range(3))
        for i in range(3)
    )
