"""EOM-IP/EA-CCSD: ionization potentials and electron affinities.

A capability BEYOND the reference: its EOM machinery is an unimplemented
stub for EE targets only (/root/reference/ECW_CC/gamma_exp.py:464-470) and
it has no IP/EA ladder at all.  Instead of hand-transcribing the sigma
equations, they are DERIVED by the in-house Wick engine
(ops/wick.generate_eom_terms): every einsum term of

    sigma_mu = <mu| H_N e^T R |0>,   mu in {1h, 2h1p} (IP) / {1p, 2p1h} (EA)

is produced programmatically and evaluated block-wise on GEris (the
canonicalized subscripts land exactly on the stored oooo/vooo/vovo/vvoo/
vovv/vvvo/vvvv blocks).  Correctness is pinned by a determinant-space
identity: with the R-disconnected terms kept (connected=False), the sigma
matrix equals the projection  P (e^-T H_N e^T) P  onto the 1h+2h1p
(1p+2p1h) determinants at ARBITRARY amplitudes — tested against oracle.py's
exact construction in tests/test_eom_ipea.py.  The production solver uses
the connected variant (eigenvalues are omega directly) with Davidson
(utils.linalg.davidson_nosym) in the antisymmetry-projected subspace.

For a 2-electron system the 1h+2h1p space spans the full (N-1)-electron
Fock-space sector, so EOM-IP-CCSD energies are exact (== 1-electron
eigenvalues minus the CCSD total energy) — also tested.

Evaluation is jnp.einsum under jit with eris/amplitudes as ARGUMENTS (a
closure would bake multi-GB constants into the HLO shipped to the remote
compiler — CLAUDE.md gotcha).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ecw_cc_tpu.ops.gemm import gemm_einsum

from ecw_cc_tpu.ops.wick import generate_eom_terms
from ecw_cc_tpu.utils.linalg import davidson_device

_OCC = set("ijklmnop")

# term lists are compile-time constants: cache per (kind, mu_rank, connected)
_TERMS_CACHE: dict = {}


def _terms(kind, mu_rank, connected):
    key = (kind, mu_rank, connected)
    if key not in _TERMS_CACHE:
        _TERMS_CACHE[key] = tuple(
            (coeff, tuple(pieces), out)
            for coeff, pieces, out in generate_eom_terms(
                kind, mu_rank, connected=connected))
    return _TERMS_CACHE[key]


def _block_pattern(subs):
    return "".join("o" if c in _OCC else "v" for c in subs)


def _split_vvvv_terms(terms):
    """(plain_terms, vvvv_terms): the <ab||cd> ladder terms handled by the
    packed route when the dense block is absent (pack-on-build ERIs)."""
    plain, lad = [], []
    for t in terms:
        pats = [_block_pattern(ss) for name, ss in t[1] if name == "v"]
        (lad if "vvvv" in pats else plain).append(t)
    return tuple(plain), tuple(lad)


def _ea_vvvv_packed(vvvv_op, t1, r1, r2, lad_terms):
    """The EA sigma's two <ab||cd> terms via ONE packed-ladder GEMM.

    Both generated terms are einsum('abcd,icd->iba', v, X) with
    X = coeff1 * r1[c] t1[i,d]  and  X = coeff2 * rea2[i,c,d]; since v is
    antisymmetric in (c,d) only the antisymmetric part of X contributes, so
    the combined W rides packed_vvvv_contract (which computes
    0.5*einsum('ijef,abef->ijab') for (c,d)-antisymmetric inputs) on a
    (nocc, 1, nvir, nvir) view.  The term shapes are asserted so a future
    generator change fails loudly instead of silently dropping a term."""
    from ecw_cc_tpu.ops.ladder import (PackedVVVV, SectoredVVVV,
                                       packed_vvvv_contract,
                                       sectored_vvvv_contract)

    if isinstance(vvvv_op, SectoredVVVV):
        contract = sectored_vvvv_contract   # spin-sorted pack-on-build
    elif isinstance(vvvv_op, PackedVVVV):
        contract = packed_vvvv_contract
    else:
        raise NotImplementedError(
            "EOM-EA with a non-dense vvvv supports the PackedVVVV/"
            f"SectoredVVVV routes only (got {type(vvvv_op).__name__})")
    W = jnp.zeros_like(r2)
    for coeff, pieces, out in lad_terms:
        d = dict(pieces)
        assert d.get("v") == "abcd" and out == "iba", (pieces, out)
        if "rea2" in d:
            assert d["rea2"] == "icd", pieces
            W = W + coeff * r2
        else:
            assert d.get("rea1") == "c" and d.get("t1") == "id", pieces
            x = jnp.einsum("c,id->icd", r1, t1)
            W = W + coeff * 0.5 * (x - jnp.swapaxes(x, 1, 2))
    p = contract(vvvv_op, W[:, None])[:, 0]   # (no, nv, nv)
    # einsum('abcd,icd->iab') = 2 * p; out order is 'iba'
    return 2.0 * jnp.swapaxes(p, 1, 2)


def _apply_terms(terms, eris, fsp, t1, t2, r1, r2, kind):
    nocc = t1.shape[0]
    rname1, rname2 = ("rip1", "rip2") if kind == "ip" else ("rea1", "rea2")
    tens = {"t1": t1, "t2": t2, rname1: r1, rname2: r2}

    def fblock(ss):
        sl = tuple(slice(0, nocc) if c in _OCC else slice(nocc, None)
                   for c in ss)
        return fsp[sl]

    out = None
    for coeff, pieces, out_subs in terms:
        operands = []
        subs = []
        for name, ss in pieces:
            if name == "f":
                operands.append(fblock(ss))
            elif name == "v":
                operands.append(getattr(eris, _block_pattern(ss)))
            else:
                operands.append(tens[name])
            subs.append(ss)
        expr = ",".join(subs) + "->" + out_subs
        val = coeff * gemm_einsum(expr, *operands, optimize=True)
        out = val if out is None else out + val
    return out


@partial(jax.jit, static_argnames=("kind", "connected", "use_packed"))
def _sigma(eris, vvvv_op, fsp, t1, t2, r1, r2, kind, connected=True,
           use_packed=False):
    """(sigma1, sigma2) of the EOM-IP/EA matrix acting on (r1, r2)."""
    s1 = _apply_terms(_terms(kind, 1, connected), eris, fsp, t1, t2,
                      r1, r2, kind)
    terms2 = _terms(kind, 2, connected)
    if use_packed:
        terms2, lad = _split_vvvv_terms(terms2)
    s2 = _apply_terms(terms2, eris, fsp, t1, t2, r1, r2, kind)
    if use_packed and lad:
        s2 = s2 + _ea_vvvv_packed(vvvv_op, t1, r1, r2, lad)
    return s1, s2


def _check_eris(eris, kind, vvvv_op):
    if kind == "ea" and eris.vvvv.size == 0 and vvvv_op is None:
        raise NotImplementedError(
            "EOM-EA sigma needs the <ab||ef> ladder: pass the pack-on-build "
            "vvvv_op (PackedVVVV) or rebuild with a dense eris.vvvv")
    return kind == "ea" and eris.vvvv.size == 0


def _asym2(x, kind):
    """Projector onto the physical antisymmetric doubles storage."""
    if kind == "ip":
        return 0.5 * (x - jnp.transpose(x, (1, 0, 2)))
    return 0.5 * (x - jnp.transpose(x, (0, 2, 1)))


import functools


@functools.lru_cache(maxsize=64)
def _mv_factory(kind, use_packed, nocc, nvir):
    """STABLE (mv_right, mv_left, project, unpack) for one problem config.

    The pipelined Davidson caches its jitted device programs on the matvec
    identity (utils/linalg._pl_programs); closures re-created per solve
    re-trace the sigma every call.  All operands (eris, ladder op, fock,
    amplitudes) stay jit ARGUMENTS — the functions close over static
    shape/config only."""
    n1 = nocc if kind == "ip" else nvir
    shape2 = (nocc, nocc, nvir) if kind == "ip" else (nocc, nvir, nvir)

    def unpack(v, asym=True):
        r1 = v[:n1]
        r2 = v[n1:].reshape(shape2)
        if asym:
            r2 = _asym2(r2, kind)
        return r1, r2

    def mv_right(v, mops):
        er, vvo, f, a, b = mops
        r1, r2 = unpack(v.astype(a.dtype))
        s1, s2 = _sigma(er, vvo, f, a, b, r1, r2, kind,
                        use_packed=use_packed)
        return jnp.concatenate([s1.ravel(), s2.ravel()])

    def mv_left(v, mops):
        # transpose of (A . P) is P . A^T: raw cotangent in, output doubles
        # antisymmetrized (same reasoning as ops/eom.mv_left)
        er, vvo, f, a, b = mops
        l1, l2 = unpack(v.astype(a.dtype), asym=False)
        _, vjp = jax.vjp(
            lambda x, y: _sigma(er, vvo, f, a, b, x, y, kind,
                                use_packed=use_packed),
            jnp.zeros_like(l1), jnp.zeros_like(l2))
        s1, s2 = vjp((l1, l2))
        s2 = _asym2(jnp.asarray(s2), kind)
        return jnp.concatenate([s1.ravel(), s2.ravel()])

    def project(v):
        # antisymmetry projector for the Davidson candidate directions
        # (f32 null-space spurious-root guard, utils/linalg)
        r1, r2 = unpack(v)
        return jnp.concatenate([r1.ravel(), r2.ravel()])

    # jitted for the host-side eigenvector unpacks (one dispatch instead of
    # one per eager op; ops/eom.py note)
    unpack_j = jax.jit(unpack, static_argnums=(1,))

    return mv_right, mv_left, project, unpack_j


def make_sigma_ipea(eris, t1, t2, kind, fsp=None, connected=True,
                    vvvv_op=None):
    """(sigma, sigma_left) closures at fixed amplitudes.

    sigma(r1, r2) applies the EOM-IP/EA-CCSD matrix; sigma_left applies its
    transpose (exact: jax.vjp of the jit-linear map).  vvvv_op: pack-on-build
    ladder operand (PackedVVVV) — required for EA when eris.vvvv is the
    pack-on-build placeholder; IP never touches vvvv."""
    use_packed = _check_eris(eris, kind, vvvv_op)
    if fsp is None:
        fsp = eris.fock
    if not use_packed:
        vvvv_op = None

    def sigma(r1, r2):
        return _sigma(eris, vvvv_op, fsp, t1, t2, r1, r2, kind, connected,
                      use_packed)

    def sigma_left(l1, l2):
        _, vjp = jax.vjp(lambda a, b: _sigma(eris, vvvv_op, fsp, t1, t2,
                                             a, b, kind, connected,
                                             use_packed),
                         jnp.zeros_like(l1), jnp.zeros_like(l2))
        return vjp((l1, l2))

    return sigma, sigma_left


def _diag_guess(eris, kind, nroots):
    """Koopman diagonal + unit-vector guesses.

    IP: omega ~ -e_i (highest occupied first); EA: omega ~ e_a (lowest
    virtual first)."""
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(np.asarray(eris.fock))
    e_o, e_v = mo_e[:nocc], mo_e[nocc:]
    if kind == "ip":
        d1 = -e_o
        d2 = (-e_o[:, None, None] - e_o[None, :, None]
              + e_v[None, None, :])
        order = np.argsort(-e_o)
        n1 = nocc
    else:
        d1 = e_v
        d2 = (-e_o[:, None, None] + e_v[None, :, None]
              + e_v[None, None, :])
        order = np.argsort(e_v)
        n1 = nvir
    diag = np.concatenate([d1.ravel(), d2.ravel()])
    guesses = []
    for k in range(min(nroots, n1)):
        g = np.zeros(diag.size)
        g[order[k]] = 1.0
        guesses.append(g)
    # more roots than 1h/1p slots: seed the lowest-diagonal doubles too
    for k in range(max(0, nroots - n1)):
        g = np.zeros(diag.size)
        g[n1 + int(np.argsort(d2.ravel())[k])] = 1.0
        guesses.append(g)
    return diag, guesses


def eom_ipea_ccsd(eris, t1, t2, kind, nroots=1, fsp=None, guess=None,
                  tol=1e-7, max_space=30, max_cycle=120, left=False,
                  vvvv_op=None, verbose=False):
    """EOM-IP/EA-CCSD roots by Davidson on the Wick-derived sigma.

    :param kind: 'ip' (omega = E_{N-1} - E_CCSD, positive ionization
        energies) or 'ea' (omega = E_{N+1} - E_CCSD, negative = bound anion).
    :return: (omegas, Rs) with Rs[k] = (r1, r2) in the storage conventions
        rip2[i,j,a] (antisym i,j) / rea2[i,a,b] (antisym a,b); with
        left=True also Ls, biorthonormalized so <L_k|R_k> = 1.
    """
    nocc, nvir = t1.shape
    n1 = nocc if kind == "ip" else nvir
    shape2 = (nocc, nocc, nvir) if kind == "ip" else (nocc, nvir, nvir)
    # eris/amplitudes travel to the Davidson as matvec OPERANDS (jit
    # arguments), never closure constants: a closure bakes the ERI blocks
    # into the matvec HLO, XLA constant-folds v^4 transposes at compile
    # time, and every new operand set recompiles (utils/linalg docstring)
    use_packed = _check_eris(eris, kind, vvvv_op)
    ops = (eris, vvvv_op if use_packed else None,
           eris.fock if fsp is None else fsp, t1, t2)
    diag, auto_guess = _diag_guess(eris, kind, nroots)
    if guess is None:
        guess = auto_guess

    # STABLE matvec/projector objects from the lru_cached factory: the
    # pipelined Davidson caches its jitted programs on the matvec identity
    # (utils/linalg._pl_programs) — per-call closures re-traced the sigma
    # on every solve (~1.5-2 s host tracing each, r4 measurement)
    mv_right, mv_left_, _project, unpack = _mv_factory(
        kind, use_packed, nocc, nvir)

    conv, w, xs = davidson_device(mv_right, guess, diag,
                                        nroots=nroots, tol=tol,
                                        max_cycle=max_cycle,
                                        max_space=max_space,
                                        verbose=verbose, operands=ops,
                                        project=_project)
    if not all(conv[:nroots]):
        import warnings

        warnings.warn(
            f"EOM-{kind.upper()} Davidson unconverged roots: "
            f"conv={list(conv[:nroots])} "
            f"omegas={[float(x) for x in w[:nroots]]} (tol={tol})",
            RuntimeWarning, stacklevel=2)
    omegas = [float(x) for x in w[:nroots]]
    xs_h = jax.device_get(list(xs[:nroots]))     # ONE batched transfer
    Rs = []
    for k in range(nroots):
        v = np.asarray(xs_h[k])
        v = v / np.linalg.norm(v)
        # canonical phase: first near-maximal component positive (tolerant
        # tie-break, see ops/eom.py) — Dyson orbitals flip with the
        # eigenvector sign otherwise
        av = np.abs(v)
        idx = int(np.argmax(av >= 0.999 * av.max()))
        if v[idx] < 0:
            v = -v
        Rs.append(tuple(jax.device_get(
            unpack(jnp.asarray(v, dtype=t1.dtype)))))
    if not left:
        return omegas, Rs

    mv_left = mv_left_

    Ls = []
    for k in range(nroots):
        xl0 = [np.concatenate([np.asarray(Rs[k][0]).ravel(),
                               np.asarray(Rs[k][1]).ravel()])]
        conv_l, wl, xls = davidson_device(mv_left, xl0, diag,
                                                nroots=1, tol=tol,
                                                max_cycle=max_cycle,
                                                max_space=max_space,
                                                follow=True, operands=ops,
                                                project=_project)
        if not conv_l[0]:
            import warnings

            warnings.warn(
                f"EOM-{kind.upper()} left Davidson unconverged for root {k} "
                f"(omega={omegas[k]:.6f}, tol={tol})",
                RuntimeWarning, stacklevel=2)
        l1, l2 = jax.device_get(unpack(jnp.asarray(np.asarray(xls[0]),
                                                   dtype=t1.dtype)))
        # METRIC CORRECTION + biorthonormalization (see ops/eom.py): the
        # raw-storage metric counts each (i<j) / (a<b) slot 2x, so the
        # true left eigenvector is D.y with D = diag(1, 2); returned Ls
        # are operator-convention (1/2-weighted storage, same as the R
        # operators) with <L|R> = l1.r1 + 1/2 l2.r2 = 1 — the
        # normalization the Dyson pole strengths assume.  The raw A^T
        # eigvec is (l1, l2/2).
        l1 = np.asarray(l1)
        l2 = 2.0 * np.asarray(l2)
        ov = np.vdot(l1, Rs[k][0]) + 0.5 * np.vdot(l2, Rs[k][1])
        Ls.append((l1 / ov, l2 / ov))
    return omegas, Rs, Ls


def _dyson_terms(kind, side, p_space):
    key = ("dyson", kind, side, p_space)
    if key not in _TERMS_CACHE:
        from ecw_cc_tpu.ops.wick import generate_dyson_terms

        _TERMS_CACHE[key] = tuple(
            (coeff, tuple(pieces), out)
            for coeff, pieces, out in generate_dyson_terms(kind, side,
                                                           p_space))
    return _TERMS_CACHE[key]


def _eval_dyson_block(terms, tens, size, dtype):
    acc = jnp.zeros((size,), dtype=dtype)
    for coeff, pieces, out in terms:
        operands = [tens[name] for name, _ in pieces]
        subs = [ss for _, ss in pieces]
        acc = acc + coeff * gemm_einsum(",".join(subs) + "->" + out,
                                        *operands, optimize=True)
    return acc


def dyson_orbitals(t1, t2, Rs, Ls, kind, lam1=None, lam2=None):
    """Dyson orbitals + pole strengths of EOM-IP/EA roots.

    d^L_p = <0| L_k (e^-T a#_p e^T) |0>,
    d^R_p = <0| (1+Lambda) (e^-T a#_p e^T) R_k |0>,
    with a#_p = a_p / a+_p by (kind, side); terms derived by
    wick.generate_dyson_terms and validated against the determinant space
    (tests/test_eom_ipea.py).  The pole strength (spectroscopic intensity
    factor) is the biorthogonal product  s_k = d^L . d^R.

    lam1/lam2: converged GS Lambda amplitudes (models/gamma_exp.solve_lambda);
    None uses Lambda = 0 (the bra <0|e^-T — a cruder CC bra; strengths then
    lose the Lambda dressing).

    :param Rs, Ls: right/left eigenvectors from eom_ipea_ccsd(left=True).
    :return: list of (dL (nmo,), dR (nmo,), strength) per root, NumPy.
    """
    nocc, nvir = t1.shape
    dtype = t1.dtype
    if lam1 is None:
        lam1 = jnp.zeros_like(t1)
    if lam2 is None:
        lam2 = jnp.zeros_like(t2)
    lname1, lname2 = ("lip1", "lip2") if kind == "ip" else ("lea1", "lea2")
    rname1, rname2 = ("rip1", "rip2") if kind == "ip" else ("rea1", "rea2")
    out = []
    for (r1, r2), (e1, e2) in zip(Rs, Ls):
        tens = {"t1": t1, "t2": t2, "l1": lam1, "l2": lam2,
                lname1: jnp.asarray(e1, dtype=dtype),
                lname2: jnp.asarray(e2, dtype=dtype),
                rname1: jnp.asarray(r1, dtype=dtype),
                rname2: jnp.asarray(r2, dtype=dtype)}
        dL = jnp.concatenate([
            _eval_dyson_block(_dyson_terms(kind, "left", "o"), tens,
                              nocc, dtype),
            _eval_dyson_block(_dyson_terms(kind, "left", "v"), tens,
                              nvir, dtype)])
        dR = jnp.concatenate([
            _eval_dyson_block(_dyson_terms(kind, "right", "o"), tens,
                              nocc, dtype),
            _eval_dyson_block(_dyson_terms(kind, "right", "v"), tens,
                              nvir, dtype)])
        out.append((np.asarray(dL), np.asarray(dR),
                    float(jnp.dot(dL, dR))))
    return out


def eom_ip_ccsd(eris, t1, t2, **kw):
    """Ionization potentials: see eom_ipea_ccsd."""
    return eom_ipea_ccsd(eris, t1, t2, "ip", **kw)


def eom_ea_ccsd(eris, t1, t2, **kw):
    """Electron affinities: see eom_ipea_ccsd."""
    return eom_ipea_ccsd(eris, t1, t2, "ea", **kw)
