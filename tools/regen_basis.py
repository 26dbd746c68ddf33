"""Basis-set regeneration machinery (in-house equivalents of published sets).

Published Gaussian basis parameters (EMSL digits) are not available offline,
so sets beyond the exactly-remembered ones are REGENERATED with Dunning's
construction (round-1 precedent: N/O cc-pVDZ, C cc-pVTZ):

  1. optimize primitive exponents variationally for the HF ground-state atom
     (UHF on the decontracted set; even-tempered warm start, then free
     refinement, Nelder-Mead in log space);
  2. contraction coefficients = atomic-HF orbital coefficients of the
     optimized decontracted atom (segmented extraction);
  3. polarization/diffuse exponents use the documented Pople/Dunning
     conventions (single-d values, 2d = {2x, x/2} splits, shared diffuse sp).

Round 1 ran this machinery from the working tree; this file commits it.

Usage:
    python tools/regen_basis.py 6-311g          # optimize C/N/O (11s,5p) cores
    python tools/regen_basis.py cc-pvtz-no      # optimize N/O cc-pVTZ sp cores

Emits Python dict literals ready to paste into models/basis_data.py, plus
the atomic energies (decontracted vs contracted) for the record.
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from ecw_cc_tpu.models.molecule import Molecule
from ecw_cc_tpu.models.scf import UHF

ATOM_SPIN = {"H": 1, "C": 2, "N": 3, "O": 2,
             "Na": 1, "Mg": 0, "Al": 1, "Si": 2, "P": 3, "S": 2,
             "Cl": 1, "Ar": 0}


def atom_energy(el, shells):
    """UHF energy of the isolated atom in the given basis (large = failed)."""
    try:
        mol = Molecule(f"{el} 0 0 0", {el: shells}, spin=ATOM_SPIN[el])
        mf = UHF(mol)
        e = mf.kernel()
        if not np.isfinite(e):
            return 1e3, None
        return e, mf
    except Exception:
        return 1e3, None


def decontracted(exps_by_l):
    """[(l, exps)] -> one single-primitive shell per exponent."""
    shells = []
    for l, exps in exps_by_l:
        for a in exps:
            shells.append((l, [(float(a), 1.0)]))
    return shells


def _exps_from_x(x, structure):
    """Unpack flat log-params into [(l, exps)] following `structure`:
    each entry (l, kind, n) with kind 'et' (2 params: log a0, log ratio)
    or 'free' (n params)."""
    out = []
    i = 0
    for l, kind, n in structure:
        if kind == "et":
            a0, r = np.exp(x[i]), np.exp(x[i + 1])
            exps = [a0 * r ** k for k in range(n)]
            i += 2
        else:
            exps = list(np.exp(x[i:i + n]))
            i += n
        out.append((l, exps))
    return out


def _merge_l(exps_by_l):
    """Merge same-l entries preserving order (for shell grouping info)."""
    return exps_by_l


def optimize_atom(el, structure, x0, maxiter_et=400, maxiter_free=800,
                  verbose=True):
    """Two-stage exponent optimization: structured (even-tempered) warm start,
    then free refinement of every exponent.

    maxiter_free=0 skips stage 2 and returns the even-tempered exponents:
    for SEGMENTED extraction the free stage is actively harmful — it
    scrambles the exponent ordering across groups (measured on row-2 S: a
    29.8 exponent drifted into the 6-primitive core group), so the
    descending-sorted segments no longer align with 1s/2s/3s character
    and the contraction loses ~190 Ha; the joint contracted refinement
    (optimize_contracted) recovers the freedom afterwards."""
    from scipy.optimize import minimize

    n_eval = [0]

    def f_struct(x):
        n_eval[0] += 1
        e, _ = atom_energy(el, decontracted(_exps_from_x(x, structure)))
        return e

    t0 = time.time()
    res = minimize(f_struct, x0, method="Nelder-Mead",
                   options=dict(maxiter=maxiter_et, xatol=1e-4, fatol=1e-7))
    exps_by_l = _exps_from_x(res.x, structure)
    if verbose:
        print(f"  [{el}] stage 1 (even-tempered): E = {res.fun:.6f} "
              f"({n_eval[0]} evals, {time.time() - t0:.0f} s)", flush=True)
    if maxiter_free == 0:
        return exps_by_l, res.fun

    # stage 2: every exponent free
    free_struct = [(l, "free", len(exps)) for l, exps in exps_by_l]
    xf = np.concatenate([np.log(exps) for _, exps in exps_by_l])
    n_eval[0] = 0

    def f_free(x):
        n_eval[0] += 1
        e, _ = atom_energy(el, decontracted(_exps_from_x(x, free_struct)))
        return e

    t0 = time.time()
    res2 = minimize(f_free, xf, method="Nelder-Mead",
                    options=dict(maxiter=maxiter_free, xatol=1e-5, fatol=1e-8))
    exps_by_l = _exps_from_x(res2.x, free_struct)
    if verbose:
        print(f"  [{el}] stage 2 (free):          E = {res2.fun:.6f} "
              f"({n_eval[0]} evals, {time.time() - t0:.0f} s)")
    return exps_by_l, res2.fun


def extract_contractions(el, exps_by_l, pattern):
    """Segmented contraction from atomic-HF orbital coefficients.

    pattern: {l: [n1, n2, ...]} — how many (sorted, descending) primitives go
    into each contracted function; primitives beyond sum(pattern[l]) become
    single free functions; a pattern entry of 1 is a free function.
    Returns the shell list in models/basis_data.py layout.
    """
    # merge all same-l groups, sort descending
    merged = {}
    for l, exps in exps_by_l:
        merged.setdefault(l, []).extend(exps)
    exps_srt = [(l, sorted(v, reverse=True)) for l, v in sorted(merged.items())]
    e_dec, mf = atom_energy(el, decontracted(exps_srt))
    assert mf is not None, "decontracted atom failed"
    C = mf.mo_coeff[0]  # alpha orbitals
    occ = mf.mo_occ[0]

    # AO row offsets: shells in insertion order, each l contributes (2l+1)
    rows_by_l = {}
    row = 0
    for l, exps in exps_srt:
        lst = rows_by_l.setdefault(l, [])
        for _ in exps:
            lst.append(row)  # row of the first component of this shell
            row += 2 * l + 1

    # orbital character: an MO belongs to l if its largest |coeff| row is
    # one of that l's rows (+ component)
    def mo_l_and_component(mo):
        r = int(np.argmax(np.abs(C[:, mo])))
        for l, rlist in rows_by_l.items():
            for r0 in rlist:
                if r0 <= r < r0 + 2 * l + 1:
                    return l, r - r0
        raise RuntimeError("row mapping failed")

    # pick, per l, the occupied MOs of that character (ascending energy).
    # Shell levels are identified by GAP CLUSTERING, not exact-energy
    # dedup: open-shell UHF atoms break spherical symmetry (S: the
    # partially-filled 3p splits the 2p m-components by ~1e-2 Ha), so an
    # exact-energy key returns two 2p components as "two levels" and the
    # 3p contraction is silently a 2p copy (seen: row-2 S general
    # contraction 0.78 Ha high).  Same-shell splittings are << the
    # inter-shell gaps (2p vs 3p: ~5 Ha), so a 0.5 Ha gap threshold is
    # unambiguous.
    cand_by_l = {l: [] for l, _ in exps_srt}
    for mo in range(C.shape[1]):
        if occ[mo] <= 0:
            continue
        l, comp = mo_l_and_component(mo)
        cand_by_l[l].append((float(mf.mo_energy[0][mo]), mo, comp))
    mos_by_l = {}
    for l, cands in cand_by_l.items():
        cands.sort()
        kept = []
        for e, mo, comp in cands:
            if not kept or e - kept[-1][0] > 0.5:
                kept.append((e, mo, comp))
        mos_by_l[l] = kept

    shells = []
    for l, exps in exps_srt:
        pat = pattern.get(l, [1] * len(exps))
        mo_iter = iter(sorted(mos_by_l.get(l, [])))
        if isinstance(pat, dict):
            # GENERAL contraction (cc-pVXZ style): pat = {"gen": (n_fn,
            # n_prims), "free": n_free} — n_fn contracted functions each
            # spanning the n_prims tightest primitives (coefficients from
            # the lowest occupied l-type MOs), plus the n_free smallest
            # primitives as additional single functions.
            n_fn, n_prims = pat["gen"]
            for _ in range(n_fn):
                _, mo, comp = next(mo_iter)
                block = exps[:n_prims]
                coefs = [float(C[rows_by_l[l][k] + comp, mo])
                         for k in range(n_prims)]
                if coefs[0] < 0:
                    coefs = [-c for c in coefs]
                shells.append((l, [(a, c) for a, c in zip(block, coefs)]))
            for a in exps[len(exps) - pat["free"]:]:
                shells.append((l, [(a, 1.0)]))
            continue
        start = 0
        for n in pat:
            block = exps[start:start + n]
            if n == 1:
                shells.append((l, [(block[0], 1.0)]))
            else:
                try:
                    _, mo, comp = next(mo_iter)
                except StopIteration:
                    raise RuntimeError(
                        f"not enough occupied {l}-type atomic orbitals for "
                        f"the contraction pattern of {el}")
                coefs = [float(C[rows_by_l[l][exps.index(a)] + comp, mo])
                         for a in block]
                # sign convention: leading coefficient positive
                if coefs[0] < 0:
                    coefs = [-c for c in coefs]
                shells.append((l, [(a, c) for a, c in zip(block, coefs)]))
            start += n
    e_con, _ = atom_energy(el, shells)
    print(f"  [{el}] decontracted E = {e_dec:.6f}, "
          f"segmented-contracted E = {e_con:.6f} (dE = {e_con - e_dec:.2e})")
    return shells


def _prim_overlap(exps, l):
    """Overlap matrix of NORMALIZED same-l Gaussian primitives:
    S_ij = (2 sqrt(a_i a_j) / (a_i + a_j))^(l + 3/2)."""
    a = np.asarray(exps)
    return (2.0 * np.sqrt(np.outer(a, a)) / np.add.outer(a, a)) ** (l + 1.5)


def extract_contractions_lsq(el, exps_by_l):
    """Segmented contraction by LEAST-SQUARES projection of each atomic
    MO onto its primitive GROUP (in the primitive-overlap metric).

    Unlike extract_contractions this does NOT merge-and-sort the
    exponents: each entry of exps_by_l IS one segment (a structure group
    from optimize_atom) — merge-sorting interleaves the et groups on
    row-2 atoms (S: group-2's 486 lands inside the 6-primitive core
    window) and any windowed extraction then loses ~190 Ha.  Groups with
    n >= 2 primitives become contractions fitted to successive occupied
    l-MOs (ascending energy); n == 1 groups stay free.

    Fit: c_seg = S_seg,seg^-1 S_seg,all c_all, renormalized; c_all are
    the decontracted-atom MO coefficients over ALL same-l primitives."""
    e_dec, mf = atom_energy(el, decontracted(exps_by_l))
    assert mf is not None, "decontracted atom failed"
    C = mf.mo_coeff[0]
    occ = mf.mo_occ[0]

    # flat primitive list per l IN GROUP ORDER + AO row of each primitive
    prims_by_l = {}
    row = 0
    rows_by_l = {}
    for l, exps in exps_by_l:
        for a in exps:
            prims_by_l.setdefault(l, []).append(a)
            rows_by_l.setdefault(l, []).append(row)
            row += 2 * l + 1

    def mo_l_and_component(mo):
        r = int(np.argmax(np.abs(C[:, mo])))
        for l, rlist in rows_by_l.items():
            for r0 in rlist:
                if r0 <= r < r0 + 2 * l + 1:
                    return l, r - r0
        raise RuntimeError("row mapping failed")

    mos_by_l = {l: [] for l in prims_by_l}
    for mo in range(C.shape[1]):
        if occ[mo] <= 0:
            continue
        l, comp = mo_l_and_component(mo)
        key = round(float(mf.mo_energy[0][mo]), 6)
        if not any(k == key for k, _, _ in mos_by_l[l]):
            mos_by_l[l].append((key, mo, comp))

    mo_iters = {l: iter(sorted(v)) for l, v in mos_by_l.items()}
    offsets = {}
    shells = []
    for l, exps in exps_by_l:
        start = offsets.get(l, 0)
        offsets[l] = start + len(exps)
        if len(exps) == 1:
            shells.append((l, [(float(exps[0]), 1.0)]))
            continue
        _, mo, comp = next(mo_iters[l])
        all_exps = prims_by_l[l]
        S_full = _prim_overlap(all_exps, l)
        block = list(range(start, start + len(exps)))
        c_all = np.array([C[rows_by_l[l][k] + comp, mo]
                          for k in range(len(all_exps))])
        S_bb = S_full[np.ix_(block, block)]
        S_ba = S_full[block, :]
        c_seg = np.linalg.solve(S_bb, S_ba @ c_all)
        nrm = float(np.sqrt(c_seg @ S_bb @ c_seg))
        c_seg = c_seg / nrm
        if c_seg[np.argmax(np.abs(c_seg))] < 0:
            c_seg = -c_seg
        shells.append((l, [(float(a), float(c)) for a, c in
                           zip(exps, c_seg)]))
    e_con, _ = atom_energy(el, shells)
    print(f"  [{el}] decontracted E = {e_dec:.6f}, "
          f"lsq-contracted E = {e_con:.6f} (dE = {e_con - e_dec:.2e})",
          flush=True)
    return shells


def optimize_contracted(el, shells0, maxiter=3000, verbose=True,
                        coef_only=False, method="Nelder-Mead"):
    """Joint variational refinement of the CONTRACTED basis: all exponents
    (log space) and all contraction coefficients of multi-primitive shells
    are free parameters; minimizes the contracted-atom UHF energy (this is
    Pople's construction — segmented AO extraction alone loses ~0.1 Ha).

    coef_only=True freezes the exponents (half the parameter space — a
    cheap warm stage that pulls a rough extraction into the right basin
    before the joint stage; row-2 S needed it)."""
    from scipy.optimize import minimize

    # flatten
    x0, slots = [], []
    for si, (l, prims) in enumerate(shells0):
        for pi, (a, c) in enumerate(prims):
            if not coef_only:
                slots.append((si, pi, "e"))
                x0.append(np.log(a))
            if len(prims) > 1:
                slots.append((si, pi, "c"))
                x0.append(c)

    def build(x):
        shells = [(l, [list(p) for p in prims]) for l, prims in shells0]
        for val, (si, pi, kind) in zip(x, slots):
            if kind == "e":
                shells[si][1][pi][0] = float(np.exp(val))
            else:
                shells[si][1][pi][1] = float(val)
        return [(l, [tuple(p) for p in prims]) for l, prims in shells]

    n_eval = [0]

    def f(x):
        n_eval[0] += 1
        e, _ = atom_energy(el, build(x))
        return e

    t0 = time.time()
    opts = dict(maxiter=maxiter)
    if method == "Nelder-Mead":
        opts.update(xatol=1e-5, fatol=1e-9)
    res = minimize(f, np.asarray(x0), method=method, options=opts)
    if verbose:
        tag = "coef-only" if coef_only else "joint"
        print(f"  [{el}] stage 3 (contracted {tag}, {method}): "
              f"E = {res.fun:.6f} ({n_eval[0]} evals, "
              f"{time.time() - t0:.0f} s)", flush=True)
    return build(res.x), res.fun


def emit(el, shells, per_line=3):
    print(f"    '{el}': [")
    for l, prims in shells:
        body = ", ".join(f"({a:.7g}, {c:.7g})" for a, c in prims)
        print(f"        ({l}, [{body}]),")
    print("    ],")


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------

def run_6311g():
    """(11s,5p)/[4s,3p] cores for C, N, O (H uses the exact published set)."""
    # structure: s = 6 core (ET) + 3 mid (ET) + 2 free ; p = 3 (ET) + 2 free
    structure = [(0, "et", 6), (0, "et", 3), (0, "free", 2),
                 (1, "et", 3), (1, "free", 2)]
    starts = {
        "C": [np.log(4500.0), np.log(0.205), np.log(11.0), np.log(0.27),
              np.log(0.46), np.log(0.145),
              np.log(19.0), np.log(0.23), np.log(0.40), np.log(0.125)],
        "N": [np.log(6300.0), np.log(0.205), np.log(15.0), np.log(0.27),
              np.log(0.65), np.log(0.20),
              np.log(27.0), np.log(0.23), np.log(0.55), np.log(0.17)],
        "O": [np.log(8500.0), np.log(0.205), np.log(20.0), np.log(0.27),
              np.log(0.90), np.log(0.26),
              np.log(35.0), np.log(0.23), np.log(0.72), np.log(0.21)],
    }
    pattern = {0: [6, 3, 1, 1], 1: [3, 1, 1]}
    out = {}
    for el in ("C", "N", "O"):
        print(f"== {el} (11s,5p) ==")
        exps_by_l, e = optimize_atom(el, structure, np.asarray(starts[el]))
        shells = extract_contractions(el, exps_by_l, pattern)
        shells, _ = optimize_contracted(el, shells)
        out[el] = shells
    print("\n# ---- paste into basis_data.py: _6311G cores ----")
    for el, shells in out.items():
        emit(el, shells)


def run_ccpvtz_no():
    """(10s,5p)/[4s,3p] sp cores for N, O cc-pVTZ (d/f exponents use the
    documented Dunning values; general contraction = two shells sharing all
    10 s primitives, like the embedded C set)."""
    structure = [(0, "et", 6), (0, "et", 2), (0, "free", 2),
                 (1, "et", 3), (1, "free", 2)]
    starts = {
        "N": [np.log(11000.0), np.log(0.20), np.log(3.9), np.log(0.28),
              np.log(0.45), np.log(0.16),
              np.log(26.0), np.log(0.225), np.log(0.52), np.log(0.16)],
        "O": [np.log(15000.0), np.log(0.20), np.log(5.2), np.log(0.28),
              np.log(0.60), np.log(0.21),
              np.log(34.0), np.log(0.225), np.log(0.70), np.log(0.21)],
    }
    out = {}
    for el in ("N", "O"):
        print(f"== {el} (10s,5p) ==")
        exps_by_l, e = optimize_atom(el, structure, np.asarray(starts[el]))
        # cc-pVTZ style (matches the embedded C set): two general s
        # contractions (1s, 2s atomic orbitals) spanning all 10 primitives +
        # 2 free s; one general p contraction over all 5 + 2 free p.
        shells = extract_contractions(
            el, exps_by_l,
            {0: {"gen": (2, 10), "free": 2}, 1: {"gen": (1, 5), "free": 2}})
        shells, _ = optimize_contracted(el, shells)
        out[el] = shells
    print("\n# ---- paste into basis_data.py: cc-pVTZ N/O sp cores ----")
    for el, shells in out.items():
        emit(el, shells)


def _slater_fit(n, l, nG=3, shared_with=None, grid=None):
    """Universal least-squares STO-NG fit: expand the zeta=1 Slater (n,l)
    radial in nG normalized Gaussian primitives of angular momentum l,
    maximizing the overlap (the Hehre-Stewart-Pople STO-3G construction;
    published digits unavailable offline, so the fit is redone in-house).

    shared_with: (n2, l2) to fit BOTH radials with SHARED exponents
    (the 2sp/3sp convention) — maximizes the summed overlap.
    Returns (exps, coefs) or (exps, coefs1, coefs2)."""
    from scipy.optimize import minimize

    r = np.linspace(1e-6, 60.0, 60000) if grid is None else grid
    dr = r[1] - r[0]

    def slater(nn):
        f = r ** (nn - 1) * np.exp(-r)
        return f / np.sqrt(np.sum(f * f * r * r) * dr)

    def gauss(a, ll):
        f = r ** ll * np.exp(-a * r * r)
        return f / np.sqrt(np.sum(f * f * r * r) * dr)

    targets = [(slater(n), l)]
    if shared_with is not None:
        n2, l2 = shared_with
        targets.append((slater(n2), l2))

    def proj(logs):
        a = np.exp(logs)
        total = 0.0
        couts = []
        for tgt, ll in targets:
            G = np.stack([gauss(ai, ll) for ai in a], axis=1)
            S = (G.T * (r * r * dr)) @ G
            m = (G.T * (r * r * dr)) @ tgt
            c = np.linalg.solve(S, m)
            ov = float(m @ c) ** 0.5          # = max overlap
            total += ov
            couts.append((c / ov, S))         # contracted fn normalized
        return total, couts

    x0 = np.log(np.array([2.0, 0.4, 0.1]) * (1.0 if n == 1 else
                                             0.25 if n == 2 else 0.08))
    res = minimize(lambda x: -proj(x)[0], x0, method="Nelder-Mead",
                   options=dict(maxiter=2000, xatol=1e-10, fatol=1e-12))
    a = np.exp(res.x)
    order = np.argsort(-a)
    a = a[order]
    _, couts = proj(np.log(a))
    out = [a] + [c for c, _ in couts]
    return tuple(out)


def run_sto3g_row2(elements=("Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar")):
    """STO-3G-EQUIVALENT sets for the second row.

    Construction: universal 3-Gaussian fits of the zeta=1 Slater 1s / 2sp /
    3sp radials (shared exponents within each sp pair, exactly the published
    STO-3G scheme), then per-element scale factors (zeta1, zeta2, zeta3)
    optimized VARIATIONALLY on the atomic UHF energy (exponents scale as
    zeta^2; contraction coefficients are scale-invariant).  Variational
    zetas make these equivalent-or-better than the published sets."""
    from scipy.optimize import minimize

    a1, c1 = _slater_fit(1, 0)
    a2, c2s_, c2p = _slater_fit(2, 0, shared_with=(2, 1))
    a3, c3s, c3p = _slater_fit(3, 0, shared_with=(3, 1))
    print("# universal fits (zeta=1):")
    print(f"#   1s : exps {np.round(a1, 7).tolist()} coefs {np.round(c1, 7).tolist()}")
    print(f"#   2sp: exps {np.round(a2, 7).tolist()} 2s {np.round(c2s_, 7).tolist()} 2p {np.round(c2p, 7).tolist()}")
    print(f"#   3sp: exps {np.round(a3, 7).tolist()} 3s {np.round(c3s, 7).tolist()} 3p {np.round(c3p, 7).tolist()}")

    # Slater-rule starting zetas
    z0 = {"Na": (10.6, 3.48, 0.84), "Mg": (11.6, 3.95, 1.10),
          "Al": (12.6, 4.40, 1.37), "Si": (13.6, 4.85, 1.60),
          "P": (14.6, 5.30, 1.85), "S": (15.5, 5.77, 2.05),
          "Cl": (16.5, 6.26, 2.26), "Ar": (17.5, 6.76, 2.45)}

    def shells_for(z1, z2, z3):
        return [
            (0, [(float(a * z1 * z1), float(c)) for a, c in zip(a1, c1)]),
            (0, [(float(a * z2 * z2), float(c)) for a, c in zip(a2, c2s_)]),
            (1, [(float(a * z2 * z2), float(c)) for a, c in zip(a2, c2p)]),
            (0, [(float(a * z3 * z3), float(c)) for a, c in zip(a3, c3s)]),
            (1, [(float(a * z3 * z3), float(c)) for a, c in zip(a3, c3p)]),
        ]

    out = {}
    for el in elements:
        t0 = time.time()

        def f(logz):
            e, _ = atom_energy(el, shells_for(*np.exp(logz)))
            return e

        res = minimize(f, np.log(z0[el]), method="Nelder-Mead",
                       options=dict(maxiter=400, xatol=1e-6, fatol=1e-9))
        z = np.exp(res.x)
        print(f"  [{el}] E = {res.fun:.6f}  zetas = {np.round(z, 5).tolist()} "
              f"({time.time() - t0:.0f} s)")
        out[el] = shells_for(*z)
    print("\n# ---- paste into basis_data.py: STO_3G second row ----")
    for el, shells in out.items():
        emit(el, shells)


def run_631g_row2(elements=("S", "P", "Cl")):
    """6-31G-QUALITY sp cores for second-row elements (an embedded
    polarized row-2 set for H2S/SO2-class systems).

    Published digits are unavailable offline.  Segmented Pople-style
    regeneration was tried and FAILED on row 2 (three routes, see git
    history: windowed/lsq extraction loses the 1s-2s-3s group alignment
    ~190 Ha; Nelder-Mead joint refinement stalls 0.4 Ha high; Powell
    exploits near-degenerate primitives into 1e14 coefficients).  So the
    scheme here is the GENERAL contraction that already works for the
    cc-pVTZ N/O cores: optimized (16s,10p) primitives, the 1s/2s/3s
    (2p/3p) atomic orbitals as general contractions over all tight
    primitives, plus one free function per l — the same [4s,3p] AO count
    as 6-31G, with no segmentation step to go wrong.  The 6-31G* d
    exponents are the standard published single values (P 0.55, S 0.65,
    Cl 0.75) added in basis_data.py."""
    structure = [(0, "et", 6), (0, "et", 6), (0, "et", 3), (0, "free", 1),
                 (1, "et", 6), (1, "et", 3), (1, "free", 1)]
    starts = {
        "S":  [np.log(22000.0), np.log(0.215), np.log(420.0), np.log(0.25),
               np.log(2.2), np.log(0.34), np.log(0.10),
               np.log(250.0), np.log(0.23), np.log(1.8), np.log(0.33),
               np.log(0.09)],
        "P":  [np.log(19000.0), np.log(0.215), np.log(360.0), np.log(0.25),
               np.log(1.9), np.log(0.34), np.log(0.09),
               np.log(210.0), np.log(0.23), np.log(1.5), np.log(0.33),
               np.log(0.08)],
        "Cl": [np.log(26000.0), np.log(0.215), np.log(490.0), np.log(0.25),
               np.log(2.6), np.log(0.34), np.log(0.12),
               np.log(300.0), np.log(0.23), np.log(2.1), np.log(0.33),
               np.log(0.10)],
    }
    out = {}
    for el in elements:
        print(f"== {el} (16s,10p)/[4s,3p] general ==", flush=True)
        exps_by_l, e = optimize_atom(el, structure, np.asarray(starts[el]))
        shells = extract_contractions(
            el, exps_by_l,
            {0: {"gen": (3, 15), "free": 1}, 1: {"gen": (2, 9), "free": 1}})
        e_fin, _ = atom_energy(el, shells)
        out[el] = shells
        print(f"  [{el}] final contracted E = {e_fin:.6f}", flush=True)
    print("\n# ---- paste into basis_data.py: _631G row-2 cores ----")
    for el, shells in out.items():
        emit(el, shells)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "6-311g"
    if which == "6-311g":
        run_6311g()
    elif which == "cc-pvtz-no":
        run_ccpvtz_no()
    elif which == "sto3g-row2":
        run_sto3g_row2()
    elif which == "6-31g-row2":
        run_631g_row2(tuple(sys.argv[2:]) or ("S", "P", "Cl"))
    else:
        raise SystemExit(f"unknown target {which}")
