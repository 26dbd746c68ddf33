"""EOM-EE-CCSD via autodiff (no hand-derived sigma equations).

At a converged CCSD point the Jacobian of the residual equations,
A_{mu nu} = dR_mu/dt_nu = <mu| e^-T [H, tau_nu] e^T |0>, IS the EOM-EE-CCSD
matrix: its right/left eigenpairs are the EOM excitation energies and R/L
amplitudes (linear-response CC eigenvalues coincide with EOM-CC for
stationary T).  The sigma vector is therefore exactly

    sigma(r) = jvp(residual, t, r)        (right)
    sigma_L(l) = vjp(residual, t)(l)      (left)

with residual = ops.ccsd.tupdate(..., equation=True), which is zero at the
solution.  Davidson (utils.linalg.davidson_nosym) runs in the antisymmetric
doubles subspace (the JVP preserves antisymmetry, so iterates stay physical
despite the raw-storage redundancy flagged in CLAUDE.md).

The reference's EOM target generator is an unimplemented stub
(gamma_exp.py:464-470); this module supplies the intended capability.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ecw_cc_tpu.ops.gemm import gemm_einsum

from ecw_cc_tpu.ops import ccsd as ccsd_ops
from ecw_cc_tpu.utils.linalg import davidson_device


from functools import partial


def _residual(eris, vvvv_op, fsp, a, b, sect):
    if sect is not None:
        from ecw_cc_tpu.ops.ccsd_sect import tupdate_sect

        # sym stays OFF inside jvp/vjp: the mirror-halved kernels fold the
        # derivative (see ops/ccsd_t.energy_t_sect's docstring); the plain
        # sectored map restricted to spin-balanced tangents/cotangents
        # equals the dense Jacobian (off-balance blocks vanish by spin
        # conservation at a balanced amplitude point)
        f = eris.fock if fsp is None else fsp
        return tupdate_sect(eris, a, b, f, sect[0], vvvv_op=vvvv_op,
                            equation=True)
    return ccsd_ops.tupdate(eris, a, b, fsp=fsp, equation=True,
                            vvvv_op=vvvv_op)


@partial(jax.jit, static_argnames=("sect",))
def _sigma_right(eris, vvvv_op, fsp, t1, t2, r1, r2, sect=None):
    # eris/amplitudes are jit ARGUMENTS, not closure constants: a closure
    # would bake the full ERI set (GBs at production sizes) into the HLO
    # shipped to the remote compiler (CLAUDE.md gotcha)
    def res(a, b):
        return _residual(eris, vvvv_op, fsp, a, b, sect)

    _, s = jax.jvp(res, (t1, t2), (r1, r2))
    return s


@partial(jax.jit, static_argnames=("sect",))
def _sigma_left(eris, vvvv_op, fsp, t1, t2, l1, l2, sect=None):
    def res(a, b):
        return _residual(eris, vvvv_op, fsp, a, b, sect)

    _, vjp = jax.vjp(res, t1, t2)
    return vjp((l1, l2))


def make_sigma(eris, t1, t2, fsp=None, vvvv_op=None, sect=None):
    """(sigma_right, sigma_left) wrappers at the converged amplitudes.

    vvvv_op: optional non-dense ladder operand (pack-on-build ERIs).  Exact
    for the Davidson iterates: right tangents are antisymmetric (where the
    packed route equals the dense ladder), and for antisymmetric cotangents
    the packed route's upper-triangle-doubled transpose collapses to the
    dense transpose under the mv_left output antisymmetrization.

    sect: optional (SectorInfo, sym) — route the residual through the
    sector-blocked kernels (sorted layout).  Exact for EOM-EE: Sz-conserving
    R/L vectors are spin-balanced, the Jacobian maps the balanced subspace
    to itself, and the Koopman guesses are balanced, so the whole Krylov
    space stays where the sectored and dense Jacobians agree."""
    def sigma(r1, r2):
        return _sigma_right(eris, vvvv_op, fsp, t1, t2, r1, r2, sect=sect)

    def sigma_left(l1, l2):
        return _sigma_left(eris, vvvv_op, fsp, t1, t2, l1, l2, sect=sect)

    return sigma, sigma_left


import functools


@functools.lru_cache(maxsize=64)
def _mv_factory(nocc, nvir, sect):
    """STABLE (mv_right, mv_left, project, unpack) for one EE problem
    config — the pipelined Davidson caches its jitted programs on the
    matvec identity (utils/linalg._pl_programs); per-call closures
    re-traced the sigma on every solve.  sect: None or the hashable
    (SectorInfo, sym) pair.  All large operands stay jit ARGUMENTS; only
    the static spin-balance masks live in the closure."""
    nov = nocc * nvir

    def _asym(r2):
        return 0.25 * (r2 - jnp.transpose(r2, (1, 0, 2, 3))
                       - jnp.transpose(r2, (0, 1, 3, 2))
                       + jnp.transpose(r2, (1, 0, 3, 2)))

    if sect is not None:
        # spin-balance projector (static masks): the sectored Jacobian's
        # off-balance sector is an exact null space, and in f32 the
        # preconditioned Davidson residuals otherwise accumulate roundoff
        # there until a spurious ~0 root converges; masking every iterate
        # and matvec output keeps the Krylov space exactly Sz-conserving
        # (binary spins: multiset balance {si,sj}=={sa,sb} iff sums match)
        inf = sect[0]
        so = np.zeros(nocc, dtype=int)
        so[inf.oa:] = 1
        sv = np.zeros(nvir, dtype=int)
        sv[inf.va:] = 1
        mask1 = jnp.asarray((so[:, None] == sv[None, :]).astype(np.float64))
        mask2 = jnp.asarray(
            ((so[:, None, None, None] + so[None, :, None, None])
             == (sv[None, None, :, None]
                 + sv[None, None, None, :])).astype(np.float64))
    else:
        mask1 = mask2 = None

    def unpack(v, asym=True):
        r1 = v[:nov].reshape(nocc, nvir)
        r2 = v[nov:].reshape(nocc, nocc, nvir, nvir)
        if asym:
            r2 = _asym(r2)
        if mask1 is not None:
            r1 = r1 * mask1.astype(r1.dtype)
            r2 = r2 * mask2.astype(r2.dtype)
        return r1, r2

    def _pack_out(s1, s2):
        if mask1 is not None:
            s1 = s1 * mask1.astype(s1.dtype)
            s2 = s2 * mask2.astype(s2.dtype)
        return jnp.concatenate([s1.ravel(), s2.ravel()])

    def mv_right(v, mops):
        er, vvo, f, a, b = mops
        s1, s2 = _sigma_right(er, vvo, f, a, b,
                              *unpack(v.astype(a.dtype)), sect=sect)
        return _pack_out(s1, s2)

    def mv_left(v, mops):
        # transpose of (A . P) is P . A^T: the raw cotangent goes into the
        # vjp unprojected, and the OUTPUT doubles part is antisymmetrized
        # (the left map restricted to the physical subspace)
        er, vvo, f, a, b = mops
        s1, s2 = _sigma_left(er, vvo, f, a, b,
                             *unpack(v.astype(a.dtype), asym=False),
                             sect=sect)
        s2 = _asym(jnp.asarray(s2))
        return _pack_out(s1, s2)

    def project(v):
        # full input-space projector (antisymmetry x spin balance) for the
        # Davidson's candidate directions (f32 null-space spurious-root
        # guard; regression: test_eom_f32_roots_match_f64)
        r1, r2 = unpack(v)
        return jnp.concatenate([r1.ravel(), r2.ravel()])

    # jitted for the HOST-side unpacks of converged eigenvectors: an eager
    # unpack dispatches one op at a time (reshape/transposes/masks); one
    # jitted call + one device_get is two round trips total
    unpack_j = jax.jit(unpack, static_argnums=(1,))

    return mv_right, mv_left, project, unpack_j


def koopman_guesses(eris, nroots, alpha_only=True, info=None):
    """Unit r1 vectors on the smallest orbital-energy gaps (Koopman);
    with alpha_only, only alpha->alpha excitations are seeded so degenerate
    spin pairs resolve deterministically.  info: SectorInfo when the eris
    are in the spin-SORTED layout (alpha block first) — without it the
    alternating [0,1,0,1,...] convention is assumed."""
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(np.asarray(eris.fock))
    gaps = mo_e[None, nocc:] - mo_e[:nocc, None]
    if alpha_only:
        mask = np.ones_like(gaps) * np.inf
        if info is not None:
            mask[:info.oa, :info.va] = 0.0  # sorted: alpha blocks first
        else:
            mask[0::2, 0::2] = 0.0  # orbspin alternates [0,1,0,1,...]
        gaps = gaps + mask
    order = np.argsort(gaps.ravel())
    guesses = []
    for k in range(nroots):
        g = np.zeros(nocc * nvir)
        g[order[k]] = 1.0
        guesses.append(g)
    return guesses


def cis_guesses(eris, nroots, info=None, alpha_only=True):
    """CIS-quality singles guesses for EOM-EE: diagonalize the explicit
    singles-singles block A[ia,jb] = d_ij d_ab (e_a - e_i) + <aj||ib> on
    the host (nov x nov, trivially small next to the doubles space) and
    seed the Davidson with its lowest eigenvectors.  Bare Koopman unit
    vectors ignore the <aj||ib> coupling that dominates low EE roots
    (singlet/triplet splitting), costing the block Davidson many cycles to
    rebuild; CIS vectors start inside the right symmetry sector.

    alpha_only: restrict to the Sz-conserving alpha->alpha (+ mirror)
    sector the production solver targets — with info (sorted layout) or
    the alternating convention.  Returns raveled r1 guesses (np arrays)."""
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(np.asarray(eris.fock))
    eia = mo_e[None, nocc:] - mo_e[:nocc, None]          # (o, v)
    ovvo = np.asarray(eris.ovvo)                          # ovvo[j,a,b,i] = <ja||bi>
    # A[ia,jb] = d_ij d_ab eia + <aj||ib>, and <aj||ib> == <ja||bi>
    # (simultaneous bra/ket label exchange), i.e. A offdiag = ovvo
    # transposed (j,a,b,i) -> (i,a,j,b).

    # Spin-paired fast path: for an RHF-derived GHF, diagonalize the two
    # spin-adapted alpha-sized blocks A+- = A_same +- A_cross (singlet /
    # triplet combinations, each (o_a*v_a)^2 = 1/16 of the full matrix)
    # with eigh (A is symmetric for real orbitals) instead of a full-space
    # nonsymmetric eig — the full eig at cc-pVDZ cost more host time than
    # the cycles it saved.
    if info is not None:
        oA = np.arange(info.oa); oB = info.oa + np.arange(info.ob)
        vA = np.arange(info.va); vB = info.va + np.arange(info.vb)
    else:
        oA = np.arange(0, nocc, 2); oB = np.arange(1, nocc, 2)
        vA = np.arange(0, nvir, 2); vB = np.arange(1, nvir, 2)
    paired = (len(oA) == len(oB) and len(vA) == len(vB)
              and np.allclose(mo_e[oA], mo_e[oB], atol=1e-10)
              and np.allclose(mo_e[nocc + vA], mo_e[nocc + vB],
                              atol=1e-10))
    if paired and len(oA) and alpha_only:
        na = len(oA) * len(vA)
        # block extractions of ovvo[j,a,b,i] -> (i,a,j,b)
        same = ovvo[np.ix_(oA, vA, vA, oA)].transpose(3, 1, 0, 2)
        cross = ovvo[np.ix_(oB, vA, vB, oA)].transpose(3, 1, 0, 2)
        same = same.reshape(na, na).copy()
        cross = cross.reshape(na, na)
        same[np.arange(na), np.arange(na)] += eia[np.ix_(oA, vA)].ravel()
        cands = []
        for sgn in (1.0, -1.0):
            M = same + sgn * cross
            Ms = 0.5 * (M + M.T)
            w, v = np.linalg.eigh(Ms)
            for k in range(min(nroots + 2, na)):
                cands.append((w[k], v[:, k], sgn))
        cands.sort(key=lambda t: t[0])
        guesses = []
        for w_k, vk, sgn in cands[:nroots]:
            g = np.zeros((nocc, nvir))
            g[np.ix_(oA, vA)] = vk.reshape(len(oA), len(vA))
            g[np.ix_(oB, vB)] = sgn * vk.reshape(len(oA), len(vA))
            guesses.append(g.ravel() / np.linalg.norm(g))
        return guesses

    A = np.transpose(ovvo, (3, 1, 0, 2)).copy()
    A = A.reshape(nocc * nvir, nocc * nvir)
    A[np.arange(nocc * nvir), np.arange(nocc * nvir)] += eia.ravel()
    w, v = np.linalg.eig(A)
    order = np.argsort(w.real)
    guesses = []
    k = 0
    for idx in order:
        g = v[:, idx].real.copy()
        if alpha_only:
            # keep only roots with weight in the alpha->alpha sector
            g2 = g.reshape(nocc, nvir)
            m = np.zeros_like(g2)
            if info is not None:
                m[:info.oa, :info.va] = 1.0
            else:
                m[0::2, 0::2] = 1.0
            if np.linalg.norm(g2 * m) < 0.5:
                continue
        nrm = np.linalg.norm(g)
        if nrm < 1e-12:
            continue
        guesses.append(g / nrm)
        k += 1
        if k == nroots:
            break
    if len(guesses) < nroots:      # pathological fallback
        guesses += koopman_guesses(eris, nroots - len(guesses),
                                   info=info)[:]
    return guesses


def eom_ccsd(eris, t1, t2, nroots=1, fsp=None, guess=None, tol=1e-7,
             max_space=30, max_cycle=120, left=False, vvvv_op=None,
             sect=None):
    """EOM-EE-CCSD roots by Davidson on the autodiff sigma.

    :return: (omegas, list of (r1, r2)) — or (omegas, Rs, Ls) with left=True,
        each L biorthonormalized so <L_k|R_k> = 1 (Euclidean on raw storage).
    """
    nocc, nvir = t1.shape
    nov = nocc * nvir
    # eris/amplitudes travel to the Davidson as matvec OPERANDS (jit
    # arguments): a matvec that closes over them would bake the ERI
    # blocks into the Davidson's _mv_block HLO as constants even though
    # _sigma_right itself takes them as arguments — the inner jit is
    # inlined when traced (utils/linalg.davidson_nosym_device docstring)
    ops = (eris, vvvv_op, fsp, t1, t2)
    mo_e = np.diag(np.asarray(eris.fock))
    d1 = (mo_e[None, nocc:] - mo_e[:nocc, None]).ravel()
    eia = mo_e[:nocc, None] - mo_e[None, nocc:]
    d2 = -(eia[:, None, :, None] + eia[None, :, None, :]).ravel()
    diag = np.concatenate([d1, d2])

    # STABLE matvec/projector objects (lru_cached factory): the pipelined
    # Davidson caches its jitted programs on the matvec identity
    # (utils/linalg._pl_programs) — per-call closures re-traced the sigma
    # on every solve
    mv_right, _mv_left_raw, _project, unpack = _mv_factory(
        nocc, nvir, sect)

    if guess is None:
        # CIS-quality guesses (r5): start inside the right singles
        # symmetry sector instead of bare Koopman unit vectors — measured
        # cycle-count lever on the EE block Davidson
        guess = cis_guesses(eris, nroots,
                            info=None if sect is None else sect[0])
    x0 = [np.concatenate([g, np.zeros(nocc * nocc * nvir * nvir)])
          for g in guess]
    conv, w, xs = davidson_device(mv_right, x0, diag, nroots=nroots,
                                        tol=tol, max_cycle=max_cycle,
                                        max_space=max_space, operands=ops,
                                        project=_project)
    if not all(conv[:nroots]):
        # an exhausted Davidson can report junk roots (e.g. ~0 from the
        # projected null space); surface it instead of silently returning
        import warnings

        warnings.warn(
            f"EOM Davidson unconverged roots: conv={list(conv[:nroots])} "
            f"omegas={[float(x) for x in w[:nroots]]} (tol={tol}; in f32 "
            "use tol>=1e-5)", RuntimeWarning, stacklevel=2)
    omegas = [float(x) for x in w[:nroots]]
    xs_h = jax.device_get(list(xs[:nroots]))     # ONE batched transfer
    Rs = []
    for k in range(nroots):
        v = np.asarray(xs_h[k])
        v = v / np.linalg.norm(v)
        # canonical phase: first near-maximal component positive (tolerant
        # tie-break: spin-partner components have analytically EQUAL
        # magnitudes, so a bare argmax is dtype/rounding-dependent) —
        # eigenvector signs are otherwise solver-dependent, which flipped
        # transition-density targets between the f32 and f64 paths
        av = np.abs(v)
        idx = int(np.argmax(av >= 0.999 * av.max()))
        if v[idx] < 0:
            v = -v
        Rs.append(tuple(jax.device_get(
            unpack(jnp.asarray(v, dtype=t1.dtype)))))
    if not left:
        return omegas, Rs

    mv_left = _mv_left_raw

    # ONE block Davidson for ALL left roots (the per-root follow-mode
    # solves cost nroots separate Davidson runs, each paying a host round
    # trip per cycle).  A^T
    # has the same spectrum as A, and the R vectors are excellent guesses
    # for the L space, so the block solve converges to the same lowest-k
    # set; each left root is then PAIRED to its right root by raw-storage
    # overlap (eigenvalue pairing alone mis-pairs degenerate multiplets).
    xr = [np.concatenate([np.asarray(R[0]).ravel(),
                          np.asarray(R[1]).ravel()]) for R in Rs]
    conv_l, wl, xls = davidson_device(mv_left, xr, diag, nroots=nroots,
                                      tol=tol, max_cycle=max_cycle,
                                      project=_project,
                                      max_space=max_space, operands=ops)
    xls = jax.device_get(list(xls))              # ONE batched transfer
    xls = [np.asarray(x) for x in xls]
    ovm = np.array([[abs(np.vdot(xl, r)) for r in xr] for xl in xls])
    Ls = [None] * nroots
    assign = {}
    for _ in range(nroots):
        j, k = np.unravel_index(np.argmax(ovm), ovm.shape)
        assign[k] = j
        ovm[j, :] = -1.0
        ovm[:, k] = -1.0
    for k in range(nroots):
        j = assign[k]
        bad = (not conv_l[j]) or abs(wl[j] - omegas[k]) > max(
            1e-3, 1e3 * tol)
        if bad:
            # fall back to the r4 per-root follow solve for this root
            conv_1, wl_1, xl_1 = davidson_device(
                mv_left, [xr[k]], diag, nroots=1, tol=tol,
                max_cycle=max_cycle, project=_project,
                max_space=max_space, follow=True, operands=ops)
            if not conv_1[0]:
                import warnings

                warnings.warn(
                    f"EOM left Davidson unconverged for root {k} "
                    f"(omega={omegas[k]:.6f}, tol={tol}); the L vector and "
                    "any transition density built from it may be "
                    "inaccurate", RuntimeWarning, stacklevel=2)
            lv = np.asarray(xl_1[0])
        else:
            lv = xls[j]
        l1, l2 = jax.device_get(unpack(jnp.asarray(lv, dtype=t1.dtype)))
        # METRIC CORRECTION + biorthonormalization.  The Davidson solves
        # the transpose of the raw-storage map, whose inner product counts
        # each physical (i<j, a<b) doubles slot 4x; the true left
        # eigenvector of the determinant-basis EOM matrix is D.y with
        # D = diag(1 on singles, 4 on doubles) (A^T_raw = D^-1 M^T D).
        # Returned Ls are OPERATOR-CONVENTION amplitudes (the same
        # 1/4-weighted storage as Lambda), normalized so
        # <L|R> = l1.r1 + 1/4 l2.r2 = 1; with them the biorthogonal
        # transition-moment product equals |<0|mu|k>|^2 in the FCI limit
        # (tests/test_eom.py).  The raw A^T eigvec is (l1, l2/4).
        l1 = np.asarray(l1)
        l2 = 4.0 * np.asarray(l2)
        ov = np.vdot(l1, Rs[k][0]) + 0.25 * np.vdot(l2, Rs[k][1])
        Ls[k] = (l1 / ov, l2 / ov)
    return omegas, Rs, Ls


_TRDM_CACHE: dict = {}


def _trdm_terms(bra, ket, ps, qs):
    key = (bra, ket, ps, qs)
    if key not in _TRDM_CACHE:
        from ecw_cc_tpu.ops.wick import generate_trdm_terms

        _TRDM_CACHE[key] = tuple(
            (c, tuple(p), o)
            for c, p, o in generate_trdm_terms(bra, ket, ps, qs))
    return _TRDM_CACHE[key]


def _eval_trdm(bra, ket, tens, nocc, nvir, dtype):
    """Assemble the full (nmo, nmo) gamma_pq from the four Wick blocks."""
    dims = {"o": nocc, "v": nvir}
    rows = []
    for ps in ("o", "v"):
        cols = []
        for qs in ("o", "v"):
            acc = jnp.zeros((dims[ps], dims[qs]), dtype=dtype)
            for coeff, pieces, out in _trdm_terms(bra, ket, ps, qs):
                operands = [tens[name] for name, _ in pieces]
                subs = [ss for _, ss in pieces]
                acc = acc + coeff * gemm_einsum(
                    ",".join(subs) + "->" + out, *operands, optimize=True)
            cols.append(acc)
        rows.append(cols)
    return jnp.block(rows)


def tr_rdm1_right(t1, t2, lam1, lam2, r1, r2, r0):
    """EOM-EE right transition rdm1 <0|(1+Lambda) (e^-T ap+.aq e^T) (r0+R)|0>.

    Terms derived by wick.generate_trdm_terms; unlike the reference's
    tr_rdm1 (CCSD.py:75-133) this INCLUDES the <0|pq-bar R|0> coupling of
    the bra's reference component with R — without it the biorthogonal
    dipole product fails the FCI identity (tests/test_eom.py)."""
    nocc, nvir = t1.shape
    tens = {"t1": t1, "t2": t2, "l1": lam1, "l2": lam2,
            "ree1": jnp.asarray(r1, dtype=t1.dtype),
            "ree2": jnp.asarray(r2, dtype=t1.dtype),
            "eye_o": jnp.eye(nocc, dtype=t1.dtype)}
    g = _eval_trdm("gs", "ree", tens, nocc, nvir, t1.dtype)
    if r0 != 0.0:
        g = g + r0 * _eval_trdm("gs", "ref", tens, nocc, nvir, t1.dtype)
    return g


def tr_rdm1_left(t1, t2, lk1, lk2):
    """EOM-EE left transition rdm1 <0|L (e^-T ap+.aq e^T)|0> (l0 = 0)."""
    nocc, nvir = t1.shape
    tens = {"t1": t1, "t2": t2,
            "lee1": jnp.asarray(lk1, dtype=t1.dtype),
            "lee2": jnp.asarray(lk2, dtype=t1.dtype),
            "eye_o": jnp.eye(nocc, dtype=t1.dtype)}
    return _eval_trdm("lee", "ref", tens, nocc, nvir, t1.dtype)


def es_rdm1(t1, t2, lk1, lk2, r1, r2, r0):
    """EOM-EE excited-state one-body density
    <0|L_k (e^-T ap+.aq e^T) (r0 + R_k)|0> (biorthogonal; l0 = 0).

    With metric-corrected, biorthonormalized L_k (eom_ccsd(left=True)),
    Tr over the occupied block gives N (electron number) exactly — the
    delta_oo overlap piece carries it.  Det-space-validated at random
    amplitudes (tests/test_eom.py)."""
    nocc, nvir = t1.shape
    tens = {"t1": t1, "t2": t2,
            "lee1": jnp.asarray(lk1, dtype=t1.dtype),
            "lee2": jnp.asarray(lk2, dtype=t1.dtype),
            "ree1": jnp.asarray(r1, dtype=t1.dtype),
            "ree2": jnp.asarray(r2, dtype=t1.dtype),
            "eye_o": jnp.eye(nocc, dtype=t1.dtype)}
    g = _eval_trdm("lee", "ree", tens, nocc, nvir, t1.dtype)
    if r0 != 0.0:
        g = g + r0 * _eval_trdm("lee", "ref", tens, nocc, nvir, t1.dtype)
    return g


def eom_r0(eris, t1, t2, r1, r2, omega, fsp=None):
    """r0 = <0|Hbar R|0> / omega, with <0|Hbar R|0> = dE/dt . R obtained by
    autodiff of the CCSD energy functional."""
    def efn(a, b):
        return ccsd_ops.energy(eris, a, b, fsp)

    _, dE = jax.jvp(efn, (t1, t2), (jnp.asarray(r1, dtype=t1.dtype),
                                    jnp.asarray(r2, dtype=t1.dtype)))
    return float(dE) / omega
