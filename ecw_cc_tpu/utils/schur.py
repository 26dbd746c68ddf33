"""Jittable small dense non-symmetric eigensolver (complex shifted-QR).

The device-resident Davidson (utils/linalg: davidson_fused_device) needs
the eigenpairs of its <= max_space projected matrix ON DEVICE so the whole
expand/project/solve/restart cycle runs inside one lax.while_loop (one
dispatch per solve instead of ~3 host round trips per cycle).  It was
written for an accelerator whose XLA backend had no non-symmetric
eigensolver; whether the GPU's own eig should replace it is open
(ROADMAP Design 3).  This module implements the classic small dense
path with static shapes:

  real Householder reduction to Hessenberg form (statically unrolled)
  -> complex single-shift QR iteration with Wilkinson shifts + deflation
     (one lax.linalg.qr per sweep: at S <= 32 a sweep is op-overhead
     bound, so one fused XLA QR beats a hand Givens chain)
  -> Schur form T, U with H = U T U^H
  -> right eigenvectors by masked triangular back-substitution (vmapped)

The host analogue it replaces is np.linalg.eig inside davidson_nosym
(the reference path is pyscf lib.davidson_nosym1's scipy eig,
/root/reference/ECW_CC/Solver_ES.py:710-711).  Accuracy matches LAPACK
hqr-style expectations (eigenpairs of non-normal matrices to O(eps*kappa));
validated against numpy.linalg.eig in tests/test_linalg_device.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _cdtype(rdt):
    return jnp.complex128 if rdt == jnp.float64 else jnp.complex64


def hessenberg(A):
    """Householder reduction of a real square matrix to upper Hessenberg.

    Returns (H, Q) with A = Q H Q^T, Q orthogonal.  The column count is
    static, so the reduction unrolls to ~6 vector ops per column."""
    S = A.shape[0]
    H = A
    Q = jnp.eye(S, dtype=A.dtype)
    tiny = jnp.asarray(jnp.finfo(A.dtype).tiny, dtype=A.dtype)
    for k in range(S - 2):
        x = H[k + 1:, k]
        nx = jnp.linalg.norm(x)
        sgn = jnp.where(x[0] >= 0, 1.0, -1.0).astype(A.dtype)
        v = x.at[0].add(sgn * nx)
        vn = jnp.linalg.norm(v)
        # zero column -> identity reflector
        v = jnp.where(vn > tiny, v / jnp.maximum(vn, tiny), jnp.zeros_like(v))
        H = H.at[k + 1:, :].add(-2.0 * jnp.outer(v, v @ H[k + 1:, :]))
        H = H.at[:, k + 1:].add(-2.0 * jnp.outer(H[:, k + 1:] @ v, v))
        Q = Q.at[:, k + 1:].add(-2.0 * jnp.outer(Q[:, k + 1:] @ v, v))
    return H, Q


def _clean_subdiag(T, eps):
    """Zero negligible subdiagonal entries (relative deflation test) and
    return the active-block bottom-row index p (p == 0 -> triangular)."""
    S = T.shape[0]
    d = jnp.abs(jnp.diagonal(T))
    sub = jnp.diagonal(T, -1)
    thr = eps * (d[:-1] + d[1:]) + jnp.finfo(jnp.real(T).dtype).tiny
    keep = jnp.abs(sub) > thr
    T = T - jnp.diag(jnp.where(keep, jnp.zeros_like(sub), sub), -1)
    idx = jnp.arange(S - 1)
    p = jnp.max(jnp.where(keep, idx, -1)) + 1
    return T, p


def schur_qr(H, Q0, max_sweeps=None, eps_factor=30.0):
    """Complex Schur form of a real upper-Hessenberg matrix by single-shift
    QR iteration with Wilkinson shifts and deflation.

    Returns (T, U, sweeps, p_final): H = U T U^H with T upper triangular up
    to the deflation tolerance; p_final == 0 certifies convergence."""
    S = H.shape[0]
    rdt = H.dtype
    cdt = _cdtype(rdt)
    eps = jnp.asarray(jnp.finfo(rdt).eps * eps_factor, dtype=rdt)
    if max_sweeps is None:
        max_sweeps = 8 * S + 40
    T0 = H.astype(cdt)
    U0 = Q0.astype(cdt)
    eye = jnp.eye(S, dtype=cdt)

    T0, p0 = _clean_subdiag(T0, eps)

    def cond(carry):
        T, U, p, it, stag = carry
        return (p > 0) & (it < max_sweeps)

    def body(carry):
        T, U, p, it, stag = carry
        blk = jax.lax.dynamic_slice(T, (p - 1, p - 1), (2, 2))
        a, b, c, d = blk[0, 0], blk[0, 1], blk[1, 0], blk[1, 1]
        tr = a + d
        disc = jnp.sqrt(tr * tr - 4.0 * (a * d - b * c))
        l1 = 0.5 * (tr + disc)
        l2 = 0.5 * (tr - disc)
        shift = jnp.where(jnp.abs(l1 - d) <= jnp.abs(l2 - d), l1, l2)
        # LAPACK-style exceptional shift to escape rare stagnation cycles
        exc = (stag > 0) & (stag % 12 == 0)
        shift = jnp.where(exc, d + 0.75 * jnp.abs(c).astype(cdt), shift)
        Qs, Rs = jnp.linalg.qr(T - shift * eye)
        T2 = Rs @ Qs + shift * eye
        U2 = U @ Qs
        T2, p2 = _clean_subdiag(T2, eps)
        stag2 = jnp.where(p2 < p, 0, stag + 1)
        return T2, U2, p2, it + 1, stag2

    T, U, p, it, _ = jax.lax.while_loop(
        cond, body, (T0, U0, p0, jnp.asarray(0), jnp.asarray(0)))
    return T, U, it, p


def eig_from_schur(T, U):
    """Eigenvalues and right eigenvectors from a complex Schur form.

    lam = diag(T); for each k the triangular system
    (T - lam_k I)[:k,:k] z = -T[:k,k] gives the eigenvector of T (standard
    LAPACK trevc back-substitution, with a small-diagonal guard for
    clustered eigenvalues); eigenvectors of the original matrix are U y."""
    S = T.shape[0]
    cdt = T.dtype
    rdt = jnp.real(T).dtype
    lam = jnp.diagonal(T)
    scale = jnp.max(jnp.abs(T)) + jnp.finfo(rdt).tiny
    smin = (jnp.finfo(rdt).eps * scale).astype(cdt)
    idx = jnp.arange(S)
    eye = jnp.eye(S, dtype=cdt)

    def one(k):
        mask = idx < k
        Mk = jnp.where(jnp.outer(mask, mask), T - lam[k] * eye, eye)
        d = jnp.diagonal(Mk)
        d = jnp.where(jnp.abs(d) < jnp.abs(smin), smin, d)
        Mk = Mk + jnp.diag(d - jnp.diagonal(Mk))
        rhs = jnp.where(mask, -T[:, k], jnp.zeros((), dtype=cdt))
        z = jax.scipy.linalg.solve_triangular(Mk, rhs, lower=False)
        return z + (idx == k).astype(cdt)

    Y = jax.vmap(one)(idx)            # row k = eigvec of T for lam[k]
    X = U @ Y.T                       # columns = eigvecs of the input
    nrm = jnp.linalg.norm(X, axis=0, keepdims=True)
    X = X / jnp.maximum(nrm, jnp.finfo(rdt).tiny)
    return lam, X


def eig_small(H, max_sweeps=None):
    """Eigenvalues + right eigenvectors of a small real matrix, entirely
    on device (jit/while_loop-safe).  Returns (lam, X) complex with
    H @ X[:, k] ~= lam[k] * X[:, k], X columns unit-norm."""
    Hh, Q = hessenberg(H)
    T, U, _, _ = schur_qr(Hh, Q, max_sweeps=max_sweeps)
    return eig_from_schur(T, U)
