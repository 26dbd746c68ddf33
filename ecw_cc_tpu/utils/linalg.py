"""Linear-algebra helpers + initial guesses (reference utilities.py:397-876)."""

from __future__ import annotations

import copy

import numpy as np

from ecw_cc_tpu.utils import convert


def get_norm(rs, ls, r0, l0):
    """<Psi_r|Psi_l> inner product of amplitude sets. Reference utilities.py:625-642."""
    rs = np.asarray(rs)
    ls = np.asarray(ls)
    if rs.shape != ls.shape:
        raise ValueError("shape of both sets of amplitudes must be the same")
    return l0 * np.conjugate(r0) + np.sum(np.conjugate(rs) * ls)


def ortho_QR(Mvec):
    """QR orthonormalization of column vectors. Reference utilities.py:645-655."""
    Q, _ = np.linalg.qr(Mvec)
    return Q


def ortho_SVD(mol, cL, cR):
    """Biorthogonalize two MO coefficient sets via SVD (Werner 2007).
    Reference utilities.py:658-695. `mol` may be a Molecule or an AO overlap."""
    if hasattr(mol, "intor"):
        S_AO = mol.intor("ovlp")
    elif isinstance(mol, np.ndarray):
        S_AO = mol
    else:
        raise ValueError("AO overlap must be an ndarray or a Molecule")
    if S_AO.shape[0] * 2 == cL.shape[0]:
        S_AO = convert.convert_r_to_g_rdm1(S_AO)
    S = np.einsum("mp,nq,mn->pq", np.conj(cL), cR, S_AO)
    u, sv, v = np.linalg.svd(S)
    S_inv_sqrt = np.sqrt(np.linalg.inv(np.diag(sv)))
    TL = u @ S_inv_sqrt
    TR = np.conj(v).T @ S_inv_sqrt
    return cL @ TL, cR @ TR


def ortho_GS(U, eps=1e-12):
    """Gram-Schmidt orthonormalization of columns. Reference utilities.py:698-727."""
    U = np.array(U, dtype=float)
    V = U.T
    for i in range(len(V)):
        prev = V[:i]
        coeff = prev @ V[i].T
        V[i] -= coeff @ prev
        nrm = np.linalg.norm(V[i])
        if nrm < eps:
            V[i][V[i] < eps] = 0.0
        else:
            V[i] /= nrm
    return V.T


def check_ortho(rn, ln, r0n, l0n):
    """Matrix of averaged overlaps between state vectors. Reference utilities.py:730-758."""
    n = len(rn)
    if n != len(ln):
        raise ValueError("r and l lists must have the same length")
    C = np.zeros((n, n))
    for k in range(n):
        for l in range(n):
            c_l = get_norm(rn[k], ln[l], r0n[k], l0n[l])
            c_r = get_norm(rn[l], ln[k], r0n[l], l0n[k])
            C[k, l] = np.real((c_l + c_r) / 2.0)
    return C


def ortho_es(rn, ln, r0n, l0n):
    """QR-orthonormalize the (r0, r) and (l0, l) state vectors.
    Reference utilities.py:761-801."""
    nocc, nvir = np.asarray(rn[0]).shape
    n = len(rn)
    Mr = np.zeros((nocc * nvir + 1, n))
    Ml = np.zeros((nocc * nvir + 1, n))
    for j in range(n):
        Mr[1:, j] = np.ravel(rn[j])
        Mr[0, j] = r0n[j]
        Ml[1:, j] = np.ravel(ln[j])
        Ml[0, j] = l0n[j]
    Qr = ortho_QR(Mr)
    Ql = ortho_QR(Ml)
    new_rn = [Qr[1:, i].reshape(nocc, nvir) for i in range(n)]
    new_ln = [Ql[1:, i].reshape(nocc, nvir) for i in range(n)]
    new_r0 = [Qr[0, i] for i in range(n)]
    new_l0 = [Ql[0, i] for i in range(n)]
    return new_rn, new_ln, new_r0, new_l0


def biortho_es(r1, l1, r0, l0):
    """Biorthogonalize one (r, l) pair via QR. Reference utilities.py:804-832."""
    nocc, nvir = np.asarray(r1).shape
    M = np.zeros((nocc * nvir + 1, 2))
    M[1:, 0] = np.ravel(r1)
    M[0, 0] = r0
    M[1:, 1] = np.ravel(l1)
    M[0, 1] = l0
    Q = ortho_QR(M)
    return (Q[1:, 0].reshape(nocc, nvir), Q[1:, 1].reshape(nocc, nvir),
            Q[0, 0], Q[0, 1])


def ortho_norm(rn, ln, rn0, ln0, ortho=True):
    """Normalize (and biorthogonalize for 2 states) the state vectors.
    Reference utilities.py:835-876."""
    C = check_ortho(rn, ln, rn0, ln0)
    ln_new = copy.deepcopy(list(ln))
    rn_new = copy.deepcopy(list(rn))
    ln0_new = copy.deepcopy(list(ln0))
    rn0_new = copy.deepcopy(list(rn0))
    if len(rn) == 2 and ortho:
        for c in np.tril(C, -1).ravel():
            if abs(c) > 0.001:
                rn_new[0], ln_new[1], rn0_new[0], ln0_new[1] = biortho_es(
                    rn_new[0], ln_new[1], rn0_new[0], ln0_new[1])
                rn_new[1], ln_new[0], rn0_new[1], ln0_new[0] = biortho_es(
                    rn_new[1], ln_new[0], rn0_new[1], ln0_new[0])
                C = check_ortho(rn_new, ln_new, rn0_new, ln0_new)
                break
    for i in range(len(ln_new)):
        if C[i, i] < 0.999 or C[i, i] > 1.001:
            ln_new[i] = ln_new[i] / C[i, i]
            ln0_new[i] = ln0_new[i] / C[i, i]
    return rn_new, ln_new, rn0_new, ln0_new


def check_spin(amp_r, amp_l):
    """Total spin indicator of an amplitude pair. Reference utilities.py:551-571."""
    spin_mat = np.zeros_like(np.asarray(amp_r))
    spin_mat[::2, 1::2] = -1.0
    spin_mat[1::2, 0::2] = 1.0
    return np.einsum("ia,ia,ia", np.asarray(amp_r), np.asarray(amp_l), spin_mat)


def spin_square(rdm1, mo_coeff, ovlp=1):
    """Spin multiplicity from a G-format rdm1. Reference utilities.py:574-617."""
    dm1a, dm1b = convert.convert_g_to_ru_rdm1(np.asarray(rdm1))[1]
    nao = mo_coeff.shape[0] // 2
    moa = mo_coeff[:nao, 0::2]
    mob = mo_coeff[nao:, 1::2]
    if isinstance(ovlp, np.ndarray):
        ovlpaa = moa.T @ ovlp @ moa
        ovlpbb = mob.T @ ovlp @ mob
    else:
        ovlpaa = moa.T @ moa
        ovlpbb = mob.T @ mob
    ssz = (np.einsum("ji,ij->", dm1a, ovlpaa) + np.einsum("ji,ij->", dm1b, ovlpbb)) * 0.25
    ssxy = (np.einsum("ji,ij->", dm1a, ovlpaa) + np.einsum("ji,ij->", dm1b, ovlpbb)) * 0.5
    ss = ssxy + ssz
    s = np.sqrt(ss + 0.25) - 0.5
    return s * 2 + 1


def koopman_init_guess(mo_energy, mo_occ, nstates=(1, 0), koop_idx=None,
                       core_ene_thresh=10.0):
    """Koopman r1 guesses in G format, valence/core split.
    Reference utilities.py:397-478."""
    nstates = list(nstates)
    if koop_idx is not None and sum(nstates) != len(koop_idx):
        raise ValueError("number of Koopman indices must equal number of states")
    if koop_idx is None:
        val_idx = np.zeros(nstates[0], dtype=int) if nstates[0] else [0]
        core_idx = np.zeros(nstates[1], dtype=int) if nstates[1] else [0]
    else:
        val_idx = koop_idx[: nstates[0]] if nstates[0] else [0]
        core_idx = koop_idx[nstates[0]:] if nstates[1] else [0]

    mo_energy = np.asarray(mo_energy)[0::2]
    mo_occ = np.asarray(mo_occ)[0::2]
    occidx = np.where(mo_occ > 0)[0]
    viridx = np.where(mo_occ == 0)[0]
    nocc, nvir = len(occidx), len(viridx)
    ncore = int(np.sum(np.abs(mo_energy[:nocc]) > core_ene_thresh))
    e_ia = mo_energy[viridx] - mo_energy[occidx, None]

    x0, DE = [], []
    eia_val = e_ia[ncore:, :].ravel()
    eia_core = e_ia[:ncore, :].ravel()
    if nstates[0] > eia_val.size or nstates[1] > eia_core.size:
        raise ValueError("basis too small for the requested number of states")

    nroot = min(nstates[0], eia_val.size)
    idx = np.argsort(eia_val)
    nocc_val = nocc - ncore
    for i in range(nroot):
        tmp = np.zeros(eia_val.size)
        tmp[idx[i + val_idx[i]]] = 1.0
        tmp = tmp.reshape(nocc_val, nvir)
        tmp = np.vstack([np.zeros((ncore, nvir)), tmp])
        g = convert.convert_r_to_g_amp(tmp)
        # zero the first of the two degenerate spin components
        nz = np.transpose(np.nonzero(g))
        g[tuple(nz[0])] = 0.0
        x0.append(g)
        DE.append(eia_val[idx[i + val_idx[i]]])

    nroot = min(nstates[1], eia_core.size)
    idx = np.argsort(eia_core)
    for i in range(nroot):
        tmp = np.zeros(eia_core.size)
        tmp[idx[i + core_idx[i]]] = 1.0
        tmp = tmp.reshape(ncore, nvir)
        tmp = np.vstack([tmp, np.zeros((nocc_val, nvir))])
        g = convert.convert_r_to_g_amp(tmp)
        nz = np.transpose(np.nonzero(g))
        g[tuple(nz[0])] = 0.0
        x0.append(g)
        DE.append(eia_core[idx[i + core_idx[i]]])

    return x0, DE


def get_DE(mo_energy, rs):
    """Orbital-energy difference at the largest amplitude.
    Reference utilities.py:481-493."""
    nocc, nvir = np.asarray(rs).shape
    mo_energy = np.asarray(mo_energy)
    eia = mo_energy[nocc:] - mo_energy[:nocc, None]
    idx = np.unravel_index(np.argmax(np.asarray(rs)), (nocc, nvir))
    return eia[idx]


def tdm_slater(TcL, TcR, occ_diff):
    """Biorthogonal Slater transition density matrix in AO basis.
    Reference utilities.py:496-515."""
    Tg = np.diag(occ_diff)
    return np.einsum("pi,ij,qj->pq", TcL, Tg, np.conj(TcR))


def EOM_r0(DE, t1, r1, fsp, eris_oovv, r2=None):
    """EOM r0 amplitudes. Reference utilities.py:518-548."""
    n = len(r1)
    nocc, nvir = np.asarray(r1[0]).shape
    if r2 is None:
        r2 = [np.zeros((nocc, nocc, nvir, nvir))] * n
    Xia = np.asarray(fsp)[:nocc, nocc:] + np.einsum(
        "me,imae->ia", np.asarray(t1), np.asarray(eris_oovv))
    out = []
    for k in range(n):
        r0 = np.einsum("ld,ld", Xia, np.asarray(r1[k]))
        r0 += 0.25 * np.einsum("lmde,lmde", np.asarray(eris_oovv), np.asarray(r2[k]))
        out.append(r0 / DE[k])
    return out


def davidson_nosym(matvec, x0, diag, nroots=1, tol=1e-8, max_cycle=80,
                   max_space=20, follow=False):
    """Davidson eigensolver for a non-symmetric real matrix (right
    eigenvectors), the analogue of pyscf.lib.davidson_nosym1 used by the
    reference's Solver_ES.SCF_diag (Solver_ES.py:710-711).

    :param matvec: callable v -> A v on flat vectors
    :param x0: list of initial guess vectors
    :param diag: diagonal of A (preconditioner)
    :param nroots: number of roots
    :param follow: if True, pick Ritz roots by maximum overlap with the
        initial guesses (root homing for state-specific EOM solves) instead
        of lowest eigenvalue
    :return: (converged_flags, eigenvalues, eigenvectors)
    """
    diag = np.asarray(diag, dtype=float)
    n = diag.size
    V = []
    AV = []

    def orthonormalize(v):
        for u in V:
            v = v - u * np.dot(u, v)
        nrm = np.linalg.norm(v)
        return None if nrm < 1e-12 else v / nrm

    for v in x0:
        v = orthonormalize(np.asarray(v, dtype=float).ravel())
        if v is not None:
            V.append(v)
    if not V:
        raise ValueError("no independent initial vectors")

    conv = [False] * nroots
    theta = np.zeros(nroots)
    Xs = [None] * nroots
    for _ in range(max_cycle):
        while len(AV) < len(V):
            AV.append(np.asarray(matvec(V[len(AV)])).ravel())
        m = len(V)
        H = np.array([[np.dot(V[i], AV[j]) for j in range(m)] for i in range(m)])
        w, y = np.linalg.eig(H)
        if follow:
            # overlap of each Ritz vector with the span of the guesses
            G = np.array([np.asarray(g, dtype=float).ravel() for g in x0])
            ritz_full = np.array([[np.dot(G[q], sum(y[i, k].real * V[i]
                                                    for i in range(m)))
                                   for k in range(m)] for q in range(len(G))])
            score = np.max(np.abs(ritz_full), axis=0)
            order = np.argsort(-score)
        else:
            order = np.argsort(w.real)
        w = w[order]
        y = y[:, order]
        new_dirs = []
        for k in range(min(nroots, m)):
            theta[k] = w[k].real
            xk = sum(y[i, k].real * V[i] for i in range(m))
            Axk = sum(y[i, k].real * AV[i] for i in range(m))
            r = Axk - theta[k] * xk
            Xs[k] = xk / max(np.linalg.norm(xk), 1e-300)
            conv[k] = np.linalg.norm(r) < tol
            if not conv[k]:
                denom = theta[k] - diag
                denom = np.where(np.abs(denom) < 1e-8,
                                 np.sign(denom + 1e-30) * 1e-8, denom)
                new_dirs.append(r / denom)
        if all(conv[: min(nroots, m)]) and m >= nroots:
            break
        if len(V) + len(new_dirs) > max_space:
            # collapse the subspace to the current Ritz vectors
            V = []
            AV = []
            for k in range(min(nroots, m)):
                v = orthonormalize(Xs[k].copy())
                if v is not None:
                    V.append(v)
        added = 0
        for d in new_dirs:
            v = orthonormalize(d)
            if v is not None:
                V.append(v)
                added += 1
        if added == 0 and not all(conv[:nroots]):
            break
    return conv, theta[:nroots], [Xs[k] for k in range(nroots)]


def davidson_fused_device(matvec, x0, diag, nroots=1, tol=1e-8,
                          max_cycle=80, max_space=20, follow=False,
                          guesses=None, verbose=False, operands=None,
                          project=None):
    """Fully device-resident davidson_nosym: the ENTIRE solve — expansion,
    batched matvecs, subspace projection, the small non-symmetric eig
    (utils/schur.eig_small: shifted-QR on device), Ritz extraction,
    preconditioning and restarts — runs inside one jitted lax.while_loop.
    One dispatch + one result fetch per solve, vs ~3 blocking fetches + a
    host np.linalg.eig per cycle in davidson_nosym_device.

    Same algorithm and semantics as davidson_nosym / davidson_nosym_device
    (the analogue of pyscf lib.davidson_nosym1 used by the reference at
    /root/reference/ECW_CC/Solver_ES.py:710-711); identical roots are
    pinned by tests/test_linalg_device.py and the EOM test suite.

    Requirements beyond davidson_nosym_device: the matvec must be
    jit-traceable (all call sites already are), and the x0 guesses must be
    linearly independent with len(x0) >= nroots (checked on host; every
    call site passes unit/Koopman guesses).

    project: optional jittable projector P (flat (n,) -> flat (n,),
    P^2 = P) onto the invariant subspace the operator acts in (EOM: spin
    balance x index antisymmetry).  Applied to every candidate direction
    around the CGS2 insert.  Without it, f32 preconditioned residuals
    accumulate roundoff in the operator's structural NULL space; once a
    dirt-dominated direction is normalized into V its masked image is ~0
    and a spurious ~0 eigenvalue converges as the lowest root (observed:
    EE roots [~0, ~0, 0.281] instead of [0.281, 0.308, 0.363] at
    H2O/6-31G f32, nroots=3 — BOTH Davidson variants, r4).
    """
    import jax
    import jax.numpy as jnp

    from ecw_cc_tpu.utils import schur as _schur

    diag_h = np.asarray(diag, dtype=float)
    n = diag_h.size
    x0h = np.array([np.asarray(v, dtype=float).ravel() for v in x0])
    B = x0h.shape[0]
    S = int(max_space)
    if B > S:
        raise ValueError("more guesses than max_space")
    if B < nroots:
        raise ValueError("need at least nroots independent guesses")
    # host-side independence check (the fused loop assumes m >= nroots)
    if np.linalg.matrix_rank(x0h) < nroots:
        raise ValueError("no independent initial vectors")
    dtype = jnp.zeros(0).dtype  # respect enable_x64
    cast = lambda a: jnp.asarray(a, dtype)

    if operands is None:
        def _mv1(v, ops):
            return matvec(v)
    else:
        _mv1 = matvec

    Gh = None
    if follow:
        Gh = np.array([np.asarray(g, dtype=float).ravel()
                       for g in (x0 if guesses is None else guesses)])

    def _ortho_insert(V, m, D):
        # CGS2-insert the rows of D into V starting at row m (same scheme
        # as davidson_nosym_device._ortho_insert)
        rows = jnp.arange(S)

        def body(carry, d):
            V, ptr = carry
            if project is not None:
                d = project(d)
            mask = (rows < ptr).astype(V.dtype)
            for _ in range(2):
                d = d - V.T @ ((V @ d) * mask)
            if project is not None:
                # re-project: CGS2 against (projected) V rows re-introduces
                # only O(eps) null-space content; projecting again before
                # normalization keeps V rows in range(P) to roundoff
                d = project(d)
            nrm = jnp.linalg.norm(d)
            ok = (nrm >= 1e-12) & (ptr < S)
            row = jnp.where(ok, d / jnp.maximum(nrm, jnp.finfo(V.dtype).tiny),
                            jnp.zeros_like(d))
            V = jnp.where(ok, jax.lax.dynamic_update_slice(
                V, row[None, :], (ptr, 0)), V)
            return (V, ptr + ok.astype(ptr.dtype)), nrm

        (V, ptr), _ = jax.lax.scan(body, (V, m), D)
        return V, ptr

    def _mv_rows(V, AV, start, k, ops):
        # batched matvec of the k rows at V[start:start+k] (k static).
        # Zero (rejected) rows map to zero images: the operator is linear.
        block = jax.lax.dynamic_slice(V, (start, 0), (k, n))
        Ab = jax.vmap(lambda v: _mv1(v, ops))(block).astype(V.dtype)
        return jax.lax.dynamic_update_slice(AV, Ab, (start, 0))

    @jax.jit
    def _run(x0_d, diag_d, G_d, ops):
        rows = jnp.arange(S)
        V = jnp.zeros((S, n), dtype)
        AV = jnp.zeros((S, n), dtype)
        V, m0 = _ortho_insert(V, jnp.asarray(0), x0_d)
        AV = _mv_rows(V, AV, 0, B, ops)

        def body(carry):
            V, AV, m, X, theta, rn, conv, cyc, stall = carry
            act = rows < m
            H = V @ AV.T
            H = jnp.where(jnp.outer(act, act), H, jnp.zeros((), dtype))
            # distinct large diagonal padding: inactive eigenpairs stay
            # decoupled (e_i) and sort last by real part / zero overlap
            scale = jnp.max(jnp.abs(H)) + 1.0
            H = H + jnp.diag(jnp.where(act, jnp.zeros((), dtype),
                                       scale * (2.0 + rows.astype(dtype))))
            lam, Y = _schur.eig_small(H)
            if follow:
                ov = G_d @ V.T                          # (ng, S)
                score = jnp.max(jnp.abs(ov @ jnp.real(Y).astype(dtype)),
                                axis=0)
                order = jnp.argsort(-score)
            else:
                order = jnp.argsort(jnp.real(lam))
            sel = order[:nroots]
            theta2 = jnp.real(lam)[sel].astype(dtype)
            Yr = jnp.real(Y)[:, sel].astype(dtype)      # (S, nroots)
            Xn = Yr.T @ V                               # (nroots, n)
            AXn = Yr.T @ AV
            R = AXn - theta2[:, None] * Xn
            rn2 = jnp.linalg.norm(R, axis=1)
            conv2 = rn2 < tol
            Xu = Xn / jnp.maximum(jnp.linalg.norm(Xn, axis=1, keepdims=True),
                                  jnp.finfo(dtype).tiny)
            denom = theta2[:, None] - diag_d[None, :]
            denom = jnp.where(jnp.abs(denom) < 1e-8,
                              jnp.sign(denom + 1e-30) * 1e-8, denom)
            D = jnp.where(conv2[:, None], jnp.zeros_like(R), R / denom)
            all_conv = jnp.all(conv2)

            def expand(args):
                V, AV, m = args
                n_new = jnp.sum(~conv2)

                def collapse(args):
                    V, AV, m = args
                    Vc, mc = _ortho_insert(jnp.zeros_like(V),
                                           jnp.asarray(0), Xu)
                    AVc = _mv_rows(Vc, jnp.zeros_like(AV), 0, nroots, ops)
                    return Vc, AVc, mc

                V, AV, m = jax.lax.cond(m + n_new > S, collapse,
                                        lambda a: a, (V, AV, m))
                V, ptr = _ortho_insert(V, m, D)
                AV = _mv_rows(V, AV, m, nroots, ops)
                return V, AV, ptr, ptr - m

            def hold(args):
                V, AV, m = args
                return V, AV, m, jnp.asarray(1)  # nonzero: not a stall

            V, AV, m2, added = jax.lax.cond(all_conv, hold, expand,
                                            (V, AV, m))
            stall2 = (~all_conv) & (added == 0)
            return V, AV, m2, Xu, theta2, rn2, conv2, cyc + 1, stall2

        def cond(carry):
            conv, cyc, stall = carry[6], carry[7], carry[8]
            return (cyc < max_cycle) & ~jnp.all(conv) & ~stall

        carry0 = (V, AV, m0,
                  jnp.zeros((nroots, n), dtype),
                  jnp.zeros((nroots,), dtype),
                  jnp.full((nroots,), jnp.inf, dtype),
                  jnp.zeros((nroots,), bool),
                  jnp.asarray(0), jnp.asarray(False))
        out = jax.lax.while_loop(cond, body, carry0)
        return out[3], out[4], out[5], out[6], out[7]

    G_d = None if Gh is None else cast(Gh)
    X, theta, rn, conv_d, cycles = _run(cast(x0h), cast(diag_h), G_d,
                                        operands)
    rn = np.asarray(rn)                                  # ONE result fetch
    conv = [bool(c) for c in np.asarray(conv_d)]
    theta_h = np.zeros(nroots)
    theta_h[:] = np.asarray(theta)
    if verbose:
        print(f"  davidson(fused): {int(cycles)} cycles, "
              f"|r|={[f'{r:.2e}' for r in rn]}", flush=True)
    return conv, theta_h, [X[k] for k in range(nroots)]


# Bounded FIFO cache of compiled pipelined-Davidson programs.  Keys include
# the matvec/projector IDENTITY, so a call site that passes a fresh closure
# per solve would grow this forever: on overflow the
# oldest entry is evicted (its programs are re-traced if ever needed again)
# and a one-time warning names the offender so the missing lru_cached
# factory gets fixed rather than silently churning.
_PL_PROGRAMS = {}
_PL_PROGRAMS_MAX = 64
_PL_WARNED = [False]


def _pl_programs(mv, project, S, B, nroots, n, no_ops, dkey):
    """Build (or fetch) the three jitted programs of the pipelined Davidson.

    Cached on the matvec/projector IDENTITY + static shape config: a
    davidson call that re-created its jitted closures per solve re-traced
    the sigma every time (seconds of host tracing + persistent-cache
    loads per solve).  Call sites must therefore
    pass STABLE function objects (lru_cached factories in ops/eom.py,
    ops/eom_ipea.py, solvers/es.py)."""
    import jax
    import jax.numpy as jnp

    key = (mv, project, S, B, nroots, n, no_ops, dkey)
    hit = _PL_PROGRAMS.get(key)
    if hit is not None:
        return hit

    if no_ops:
        def _mv1(v, ops):
            return mv(v)
    else:
        _mv1 = mv

    def _ortho_insert(V, m, D):
        rows = jnp.arange(S)
        tiny = jnp.finfo(V.dtype).tiny

        def body(carry, d):
            V, ptr = carry
            if project is not None:
                d = project(d)
            mask = (rows < ptr).astype(V.dtype)
            for _ in range(2):
                d = d - V.T @ ((V @ d) * mask)
            if project is not None:
                d = project(d)
            nrm = jnp.linalg.norm(d)
            ok = (nrm >= 1e-12) & (ptr < S)
            row = jnp.where(ok, d / jnp.maximum(nrm, tiny),
                            jnp.zeros_like(d))
            V = jnp.where(ok, jax.lax.dynamic_update_slice(
                V, row[None, :], (ptr, 0)), V)
            return (V, ptr + ok.astype(ptr.dtype)), nrm

        (V, ptr), _ = jax.lax.scan(body, (V, m), D)
        return V, ptr

    def _mv_rows(V, AV, start, k, ops):
        block = jax.lax.dynamic_slice(V, (start, 0), (k, n))
        Ab = jax.vmap(lambda v: _mv1(v, ops))(block).astype(V.dtype)
        return jax.lax.dynamic_update_slice(AV, Ab, (start, 0))

    def _pack(V, AV, m, rn, G_d):
        H = V @ AV.T
        return jnp.concatenate([H.ravel(), (G_d @ V.T).ravel(),
                                rn.astype(V.dtype),
                                m.astype(V.dtype)[None]])

    @jax.jit
    def init(x0_d, G_d, ops):
        dtype = x0_d.dtype
        V = jnp.zeros((S, n), dtype)
        AV = jnp.zeros((S, n), dtype)
        V, m = _ortho_insert(V, jnp.asarray(0), x0_d)
        AV = _mv_rows(V, AV, 0, B, ops)
        return V, AV, m, _pack(V, AV, m,
                               jnp.full((nroots,), jnp.inf, dtype), G_d)

    @jax.jit
    def cycle(V, AV, m, Y, theta, diag_d, tol_d, G_d, ops):
        # Ritz pairs for the HOST-provided Y/theta, residual expansion,
        # insert, matvec, restart, and the NEXT projected matrix — one
        # dispatch, one packed fetch
        tiny = jnp.finfo(V.dtype).tiny
        X = Y @ V
        AX = Y @ AV
        R = AX - theta[:, None] * X
        rn = jnp.linalg.norm(R, axis=1)
        conv = rn < tol_d
        Xu = X / jnp.maximum(jnp.linalg.norm(X, axis=1, keepdims=True),
                             tiny)
        denom = theta[:, None] - diag_d[None, :]
        denom = jnp.where(jnp.abs(denom) < 1e-8,
                          jnp.sign(denom + 1e-30) * 1e-8, denom)
        D = jnp.where(conv[:, None], jnp.zeros_like(R), R / denom)
        n_new = jnp.sum(~conv)

        def collapse(args):
            V, AV, m = args
            Vc, mc = _ortho_insert(jnp.zeros_like(V), jnp.asarray(0), Xu)
            AVc = _mv_rows(Vc, jnp.zeros_like(AV), 0, nroots, ops)
            return Vc, AVc, mc

        V, AV, m = jax.lax.cond(m + n_new > S, collapse,
                                lambda a: a, (V, AV, m))
        V, ptr = _ortho_insert(V, m, D)
        AV = _mv_rows(V, AV, m, nroots, ops)
        return V, AV, ptr, _pack(V, AV, ptr, rn, G_d)

    @jax.jit
    def ritz(V, Y):
        X = Y @ V
        return X / jnp.maximum(jnp.linalg.norm(X, axis=1, keepdims=True),
                               jnp.finfo(V.dtype).tiny)

    if len(_PL_PROGRAMS) >= _PL_PROGRAMS_MAX:
        evicted = next(iter(_PL_PROGRAMS))
        del _PL_PROGRAMS[evicted]
        if not _PL_WARNED[0]:
            _PL_WARNED[0] = True
            import warnings

            warnings.warn(
                "pipelined-Davidson program cache overflowed "
                f"({_PL_PROGRAMS_MAX} entries): a call site is passing "
                "fresh matvec/projector closures per solve (evicting "
                f"{getattr(evicted[0], '__qualname__', evicted[0])!r}); "
                "wrap the factory in functools.lru_cache for stable "
                "identities", RuntimeWarning, stacklevel=3)
    _PL_PROGRAMS[key] = (init, cycle, ritz)
    return init, cycle, ritz


def davidson_pipelined_device(matvec, x0, diag, nroots=1, tol=1e-8,
                              max_cycle=80, max_space=20, follow=False,
                              guesses=None, verbose=False, operands=None,
                              project=None):
    """ONE-round-trip-per-cycle device Davidson with a HOST small eig.

    The fully-fused variant's on-device nonsymmetric eig (utils/schur) is
    a chain of latency-bound QR sweeps; on the accelerator this code was
    first tuned for, the fused loop lost to the host-cycle variant on the
    IP/EA bench (not re-measured on the GPU).  This variant keeps the eig
    on the host (np.linalg.eig of the <= max_space projected matrix) but
    folds the whole per-cycle device work — Ritz residuals,
    preconditioned expansion, CGS2 insert, batched matvec, restart AND the
    next projected matrix — into ONE dispatch whose packed
    (H | G-overlaps | rn | m) result is fetched in ONE transfer.

    The device programs are cached on the (matvec, project) IDENTITY
    (_pl_programs): pass STABLE function objects (lru_cached factories at
    the call sites) or every solve re-traces the sigma.

    Same semantics/arguments as davidson_nosym_device (incl. `project`,
    the f32 null-space guard)."""
    import jax.numpy as jnp

    diag_h = np.asarray(diag, dtype=float)
    n = diag_h.size
    x0h = np.array([np.asarray(v, dtype=float).ravel() for v in x0])
    B = x0h.shape[0]
    S = int(max_space)
    if B > S:
        raise ValueError("more guesses than max_space")
    dtype = jnp.zeros(0).dtype  # respect enable_x64
    diag_d = jnp.asarray(diag_h, dtype)
    tol_d = jnp.asarray(tol, dtype)

    if follow:
        Gh = np.array([np.asarray(g, dtype=float).ravel()
                       for g in (x0 if guesses is None else guesses)])
    else:
        Gh = np.zeros((0, n))
    ng = Gh.shape[0]
    G_d = jnp.asarray(Gh, dtype)

    init, cycle, ritz = _pl_programs(matvec, project, S, B, nroots, n,
                                     operands is None, str(dtype))

    def _unpack(p):
        p = np.asarray(p)                        # the ONE fetch per cycle
        H = p[: S * S].reshape(S, S)
        off = S * S
        Gov = p[off: off + ng * S].reshape(ng, S)
        off += ng * S
        rn = p[off: off + nroots]
        return H, Gov, rn, int(round(float(p[off + nroots])))

    V, AV, m_dev, packed = init(jnp.asarray(x0h, dtype), G_d, operands)
    H, Gov, rn, m = _unpack(packed)
    if m < nroots:
        raise ValueError("no independent initial vectors")
    conv = [False] * nroots
    theta = np.zeros(nroots)
    Y_h = np.zeros((nroots, S))
    for cyc in range(max_cycle):
        w, y = np.linalg.eig(H[:m, :m])
        if follow:
            score = np.max(np.abs(Gov[:, :m] @ y.real), axis=0)
            order = np.argsort(-score)
        else:
            order = np.argsort(w.real)
        w = w[order]
        y = y[:, order]
        kc = min(nroots, m)
        theta[:kc] = w[:kc].real
        Y_h = np.zeros((nroots, S))
        Y_h[:kc, :m] = y[:, :nroots].real.T
        m_prev = m
        V, AV, m_dev, packed = cycle(V, AV, m_dev, jnp.asarray(Y_h, dtype),
                                     jnp.asarray(theta, dtype), diag_d,
                                     tol_d, G_d, operands)
        H, Gov, rn, m = _unpack(packed)
        conv = [bool(r < tol) for r in rn]
        if verbose:
            print(f"  davidson(pipelined) cycle {cyc:3d} m={m_prev:3d} "
                  f"|r|={[f'{r:.2e}' for r in rn]}", flush=True)
        if all(conv[:nroots]):
            break
        if m == m_prev:
            break                                # stall: no new directions
    X = ritz(V, jnp.asarray(Y_h, dtype))
    return conv, theta[:nroots].copy(), [X[k] for k in range(nroots)]


def davidson_device(matvec, x0, diag, **kw):
    """Dispatcher: the pipelined one-round-trip Davidson by default
    (the fastest variant where it was last measured), the fully-fused
    while_loop
    variant with ECW_CC_TPU_DAVIDSON=fused (one dispatch per SOLVE — wins
    only when per-cycle round-trips cost more than the on-device small
    eig), the r3 host-cycle loop with =host."""
    import os

    mode = os.environ.get("ECW_CC_TPU_DAVIDSON", "pipelined")
    if mode == "host":
        return davidson_nosym_device(matvec, x0, diag, **kw)
    if mode == "fused":
        return davidson_fused_device(matvec, x0, diag, **kw)
    return davidson_pipelined_device(matvec, x0, diag, **kw)


def davidson_nosym_device(matvec, x0, diag, nroots=1, tol=1e-8,
                          max_cycle=80, max_space=20, follow=False,
                          guesses=None, verbose=False, operands=None,
                          project=None):
    """Device-resident davidson_nosym: the basis V and its images AV live
    as (max_space, n) DEVICE arrays for the whole solve.

    The host variant round-trips full n-vectors every matvec — ~20 MB per
    iteration at pVDZ EOM sizes.  Here per-iteration host traffic is the
    (m, m) projected matrix down and one m-coefficient vector up per
    unconverged root (the tiny non-symmetric eig stays on the host).  Same algorithm and
    semantics as davidson_nosym; identical results are pinned by tests.

    :param matvec: device flat (n,) -> device flat (n,) (jit-safe ops);
        with `operands` given, called as matvec(v, operands) instead
    :param operands: optional pytree of large device arrays the matvec
        needs (eris blocks, amplitudes, packed-ladder slabs).  Passing
        them here makes them ARGUMENTS of the jitted matvec block; a
        matvec that merely closes over them bakes every array into the
        HLO as a constant — XLA then constant-folds v^4-sized transposes
        at compile time, and every Davidson call with new operands
        recompiles.
    :param follow: pick Ritz roots by max overlap with `guesses`
        (default: the x0 vectors) instead of lowest eigenvalue
    :param project: optional jittable subspace projector applied to every
        candidate direction around the CGS2 insert (see
        davidson_fused_device — the f32 null-space spurious-root guard)
    """
    import jax
    import jax.numpy as jnp

    diag_h = np.asarray(diag, dtype=float)
    n = diag_h.size
    x0 = [np.asarray(v, dtype=float).ravel() for v in x0]
    dtype = jnp.zeros(0).dtype  # respect enable_x64
    diag_d = jnp.asarray(diag_h, dtype=dtype)

    from functools import partial

    if operands is None:
        def _mv1(v, ops):
            return matvec(v)
    else:
        _mv1 = matvec

    @partial(jax.jit, static_argnames=("k",))
    def _mv_block(V, AV, start, k, ops):
        # ONE batched matvec for the k rows just written at V[start:start+k]
        # (vmap: bigger GEMMs + k-fold fewer dispatches).
        # The operator may run at a lower precision than the subspace
        # bookkeeping (f32 sigma under x64 bookkeeping, as the host
        # variant's float64 numpy did).
        block = jax.lax.dynamic_slice(V, (start, 0), (k, n))
        Ab = jax.vmap(lambda v: _mv1(v, ops))(block).astype(V.dtype)
        return jax.lax.dynamic_update_slice(AV, Ab, (start, 0))

    @jax.jit
    def _ortho_insert(V, m, D):
        # Sequentially CGS2-orthonormalize the stacked candidates D (k, n)
        # against the first `ptr` rows of V, inserting each accepted row in
        # place — ONE dispatch + one scalar fetch for the whole block (the
        # per-candidate _ortho/float(nrm) of the first version cost two
        # host round trips per direction).
        rows = jnp.arange(max_space)

        def body(carry, d):
            V, ptr = carry
            if project is not None:
                d = project(d)
            mask = (rows < ptr).astype(V.dtype)
            for _ in range(2):           # CGS2 against the masked rows
                d = d - V.T @ ((V @ d) * mask)
            if project is not None:
                d = project(d)           # see davidson_fused_device
            nrm = jnp.linalg.norm(d)
            ok = (nrm >= 1e-12) & (ptr < max_space)
            row = jnp.where(ok, d / jnp.maximum(nrm, 1e-300),
                            jnp.zeros_like(d))
            V = jnp.where(ok, jax.lax.dynamic_update_slice(
                V, row[None, :], (ptr, 0)), V)
            return (V, ptr + ok.astype(ptr.dtype)), nrm

        (V, ptr), _ = jax.lax.scan(body, (V, jnp.asarray(m)), D)
        return V, ptr

    def _add_block(V, AV, m, cand):
        """Orthonormalize candidate directions into V, then batch-matvec."""
        if not cand:
            return V, AV, m
        D = jnp.stack([jnp.asarray(d, dtype) for d in cand])
        V, ptr = _ortho_insert(V, m, D)
        added = int(ptr) - m
        if added:
            # matvec the whole candidate span [m, m+len(cand)): rejected
            # candidates leave zero rows whose images are never read (any
            # later row write re-runs _mv_block over it) — one dispatch
            # with a STATIC row count beats re-tracing on `added`
            k = min(len(cand), max_space - m)
            AV = _mv_block(V, AV, m, k, operands)
        return V, AV, m + added

    @jax.jit
    def _proj(V, AV, G):
        # one fused fetch: projected H stacked over the follow overlaps
        # (separate np.asarray calls are separate round trips)
        H = V @ AV.T
        return H if G is None else jnp.concatenate([H, G @ V.T], axis=0)

    @jax.jit
    def _ritz_all(V, AV, Y, thetas):
        # all roots in ONE dispatch; the residual norms come back in one
        # scalar-vector fetch instead of nroots separate float() fetches
        def one(y, theta):
            x = y @ V
            r = y @ AV - theta * x
            xn = x / jnp.maximum(jnp.linalg.norm(x), 1e-300)
            denom = theta - diag_d
            denom = jnp.where(jnp.abs(denom) < 1e-8,
                              jnp.sign(denom + 1e-30) * 1e-8, denom)
            return xn, jnp.linalg.norm(r), r / denom

        return jax.vmap(one)(Y, thetas)

    V = jnp.zeros((max_space, n), dtype=dtype)
    AV = jnp.zeros((max_space, n), dtype=dtype)
    V, AV, m = _add_block(V, AV, 0, [jnp.asarray(v, dtype) for v in x0])
    if m == 0:
        raise ValueError("no independent initial vectors")
    G = None
    if follow:
        G = jnp.asarray(np.array(
            [np.asarray(g, dtype=float).ravel()
             for g in (x0 if guesses is None else guesses)]), dtype)

    conv = [False] * nroots
    theta = np.zeros(nroots)
    Xs = [None] * nroots
    for cycle in range(max_cycle):
        P = np.asarray(_proj(V, AV, G))
        H = P[:max_space, :m][:m]
        w, y = np.linalg.eig(H)
        if follow:
            ov = P[max_space:, :m]                   # (nguess, m)
            score = np.max(np.abs(ov @ y.real), axis=0)
            order = np.argsort(-score)
        else:
            order = np.argsort(w.real)
        w = w[order]
        y = y[:, order]
        kc = min(nroots, m)
        theta[:kc] = w[:kc].real
        Y = np.zeros((nroots, max_space))
        Y[:kc, :m] = y[:, :nroots].real.T
        Xk, rns, Dk = _ritz_all(V, AV, jnp.asarray(Y, dtype),
                                jnp.asarray(theta, dtype))
        rns = np.asarray(rns)                        # ONE norms fetch
        new_dirs = []
        for k in range(kc):
            Xs[k] = Xk[k]
            conv[k] = float(rns[k]) < tol
            if verbose:
                print(f"  davidson cycle {cycle:3d} m={m:3d} root {k}: "
                      f"theta={theta[k]:.8f} |r|={rns[k]:.2e}", flush=True)
            if not conv[k]:
                new_dirs.append(Dk[k])
        if all(conv[:kc]) and m >= nroots:
            break
        if m + len(new_dirs) > max_space:
            # collapse the subspace to the current Ritz vectors
            V = jnp.zeros((max_space, n), dtype=dtype)
            AV = jnp.zeros((max_space, n), dtype=dtype)
            V, AV, m = _add_block(
                V, AV, 0,
                [Xs[k] for k in range(min(nroots, len(Xs)))
                 if Xs[k] is not None])
        m_before = m
        V, AV, m = _add_block(V, AV, m, new_dirs)
        if m == m_before and not all(conv[:nroots]):
            break
    return conv, theta[:nroots], [Xs[k] for k in range(nroots)]
