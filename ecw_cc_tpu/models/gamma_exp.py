"""Simulated target ("experimental") data generation.

Re-implements reference gamma_exp.py:
  - Gexp: GS target rdm1 from HF / CCSD (our own GCCSD machinery replaces
    PySCF's RCCSD), with optional static external field, random geometry
    deformation and under-fitting (random zeroed elements).
  - ESexp: excited-state targets via the MOM (delta-SCF) approach with
    SVD-biorthogonalized Slater transition density matrices.

CCSD(T) targets (reference gamma_exp.py:228-248) use the (T) lambda response
density implemented in ecw_cc_tpu.ops.ccsd_t (tested against finite-difference
derivatives in tests/test_ccsd_t.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ecw_cc_tpu.models.molecule import Molecule
from ecw_cc_tpu.models.scf import RHF, UHF, GHF
from ecw_cc_tpu.models.eris import build_eris
from ecw_cc_tpu.ops import ccsd as ccsd_ops
from ecw_cc_tpu.utils import convert, linalg, props

ANG2BOHR = 1.0 / 0.52917721092


import jax as _jax


from functools import partial as _partial


@_partial(_jax.jit, static_argnames=("sect",))
def _l_step(eris, vvvv_op, t1, t2, l1, l2, sect=None):
    if sect is not None:
        from ecw_cc_tpu.ops.ccsd_sect import lupdate_sect

        l1n, l2n = lupdate_sect(eris, t1, t2, l1, l2, eris.fock, sect[0],
                                energy_term="off", vvvv_op=vvvv_op,
                                sym=sect[1])
    else:
        l1n, l2n = ccsd_ops.lupdate(eris, t1, t2, l1, l2, None,
                                    energy_term="off", vvvv_op=vvvv_op)
    return l1n, l2n, jnp.linalg.norm(l1n) + jnp.linalg.norm(l2n)


def solve_lambda(eris, t1, t2, conv_tol=1e-10, max_cycle=200, vvvv_op=None,
                 sect=None):
    """GS Lambda amplitudes (textbook equations), jitted per step (an
    eager loop would dispatch op by op).
    sect: optional (SectorInfo, sym) sector-blocked kernels (sorted
    layout)."""
    if sect is not None:
        from ecw_cc_tpu.ops import ladder

        vvvv_op = ladder.ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])
    l1, l2 = t1, t2
    l_old = None
    for _ in range(max_cycle):
        l1, l2, nrm = _l_step(eris, vvvv_op, t1, t2, l1, l2, sect=sect)
        nrm = float(nrm)
        if l_old is not None and abs(nrm - l_old) < conv_tol:
            break
        l_old = nrm
    return l1, l2


def _spin_label(r1):
    """singlet/triplet/spin-flip label of an EE R1 block (alternating
    spin layout): the Ms=0 singlet combination is symmetric in
    alpha<->beta, the triplet antisymmetric."""
    r1 = np.asarray(r1)
    raa = r1[0::2, 0::2]
    rbb = r1[1::2, 1::2]
    off = np.linalg.norm(r1[0::2, 1::2]) + np.linalg.norm(r1[1::2, 0::2])
    if off > 0.5 * max(np.linalg.norm(r1), 1e-300):
        return "spin-flip"
    s = np.linalg.norm(raa + rbb)
    t = np.linalg.norm(raa - rbb)
    if max(s, t) < 1e-8:
        return "n/a"
    return "singlet" if s > t else "triplet"


def _swap_ov_vo(g, nocc):
    """Det-space <p+ q> layout -> the reference tr_rdm1 index convention
    (ov/vo blocks transposed; oo/vv unchanged).  Verified: the reference
    formula's pure-L part equals the swapped determinant-space matrix
    exactly (tests/test_eom.py)."""
    out = g.copy()
    out[:nocc, nocc:] = g[nocc:, :nocc].T
    out[nocc:, :nocc] = g[:nocc, nocc:].T
    return out


def _build_eris_auto(mol, ghf):
    """(eris, vvvv_op) for target-generation CC solves: in the f32
    production mode, the device build with pack-on-build — the dense
    (v,v,v,v) block is NEVER materialized on any target-generation path
    (reference hot spot CCSD.py:396-402); in f64 parity mode, the exact
    host build (dense, vvvv_op=None)."""
    from ecw_cc_tpu.config import get_config

    if get_config().dtype == "float32":
        from ecw_cc_tpu.models.eris import build_eris_device

        return build_eris_device(mol, ghf, dtype="float32", pack_ladder=True)
    return build_eris(mol, ghf).to_device(), None


def _build_eris_sorted(mol, ghf):
    """(eris, vvvv_op, sect, unperm) for CCSD / CCSD(T) target builds.

    In the f32 production mode the device build runs in the spin-SORTED
    layout (pack-on-build SectoredVVVV ladder), so the t/lambda solves,
    the o^3 v^4 (T) scans and the response-density adjoint all route
    through the sector-blocked kernels (ops/ccsd_sect.py,
    ops/ccsd_t.energy_t_sect — ~6-8x fewer FLOPs, up to 2x again under
    the closed-shell mirror gate).  The CC equations are orbital-order
    covariant, so everything runs sorted and only the final density is
    permuted back (unperm).  f64 parity mode keeps the dense host build +
    dense kernels as the oracle path."""
    from ecw_cc_tpu.config import get_config

    if get_config().dtype != "float32":
        return build_eris(mol, ghf).to_device(), None, None, None
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops import ccsd_t
    from ecw_cc_tpu.ops.ladder import spin_sort_perm
    from ecw_cc_tpu.ops.spinsect import sector_info

    eris, vvvv_op = build_eris_device(mol, ghf, dtype="float32",
                                      pack_ladder=True, sort_spin=True)
    perm = spin_sort_perm(np.asarray(ghf.orbspin), ghf.nocc)
    info = sector_info(np.asarray(ghf.orbspin)[perm], ghf.nocc)
    sym = ccsd_t.eris_spin_restricted(eris, info, vvvv_op=vvvv_op)
    return eris, vvvv_op, (info, sym), np.argsort(perm)


def _run_gccsd_rdm1(mol, mf, conv_tol=1e-10, max_cycle=200):
    """Plain GCCSD + Lambda on a converged RHF; returns (e_corr, rdm1_mo_G, ghf).

    The t solve delegates to ccsd_t.solve_ccsd (jitted steps + on-device
    DIIS) rather than keeping a second hand-rolled Jacobi loop in sync.
    In the f32 production mode the whole solve runs in the spin-sorted
    layout through the sector-blocked kernels (_build_eris_sorted); the
    returned rdm1 is permuted back to the alternating convention."""
    from ecw_cc_tpu.ops import ccsd_t

    ghf = GHF(mf)
    eris, vvvv_op, sect, unperm = _build_eris_sorted(mol, ghf)
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris, conv_tol=conv_tol,
                                     max_cycle=max_cycle, vvvv_op=vvvv_op,
                                     sect=sect)
    l1, l2 = solve_lambda(eris, t1, t2, conv_tol, max_cycle, vvvv_op=vvvv_op,
                          sect=sect)
    rdm1_mo = np.asarray(_gamma_jit(t1, t2, l1, l2, sect=sect))
    if unperm is not None:
        rdm1_mo = rdm1_mo[np.ix_(unperm, unperm)]
    return e_cc, rdm1_mo, ghf


@_partial(_jax.jit, static_argnames=("sect",))
def _gamma_jit(t1, t2, l1, l2, sect=None):
    """One jitted program for the rdm1 assembly: the sectored build expands
    into dozens of small einsums that must not dispatch eagerly one by
    one."""
    if sect is not None:
        from ecw_cc_tpu.ops.ccsd_sect import gamma_inter_sect

        inter = gamma_inter_sect(t1, t2, l1, l2, sect[0], sym=sect[1])
        return ccsd_ops.gamma_CCSD(t1, t2, l1, l2, inter=inter)
    return ccsd_ops.gamma_CCSD(t1, t2, l1, l2)


class Gexp:
    """GS target rdm1 generator. Reference gamma_exp.py:104-275."""

    def __init__(self, mol: Molecule, method, basis=None):
        self.mol_def = mol.with_basis(basis) if basis is not None else mol.copy()
        self.mf_def = RHF(self.mol_def)
        self.mo_coeff_def = None
        self.nocc = None
        self.nvir = None
        self.gamma_ao = None  # AO basis, R format
        self.method = method
        self.EHF_def = 0.0
        self.ECCSD_def = 0.0
        self.ECCSD_t_def = 0.0
        self.Eexp = 0.0

    def deform(self, def_max, rng=None):
        """Random geometry kicks up to def_max (Bohr). Reference
        gamma_exp.py:140-168 (with the intended per-coordinate indexing;
        the reference indexes dq[i+j], a bug)."""
        rng = rng or np.random.default_rng()
        natm = self.mol_def.natm
        dq = (rng.random(natm * 3) * 2 - 1) * def_max
        new_atoms = []
        for i, (sym, xyz) in enumerate(self.mol_def.atoms):
            new_atoms.append((sym, xyz + dq[3 * i:3 * i + 3]))
        self.mol_def = self.mol_def.with_geometry(new_atoms)
        self.mf_def = RHF(self.mol_def)

    def Vext(self, field):
        """Static external field on the one-electron operator.
        Reference gamma_exp.py:170-191 (dipole origin at [0,0,0])."""
        mol = self.mol_def
        h = (mol.intor("kin") + mol.intor("nuc")
             + np.einsum("x,xij->ij", np.asarray(field, float),
                         mol.intor("r", origin=np.zeros(3))))
        self.mf_def.set_hcore(h)

    def build(self):
        """HF or CCSD target calculation. Reference gamma_exp.py:193-255."""
        self.mf_def.conv_tol = 1e-11
        self.mf_def.kernel()
        self.mo_coeff_def = self.mf_def.mo_coeff
        self.nocc = int(np.sum(self.mf_def.mo_occ > 0))
        self.nvir = int(np.sum(self.mf_def.mo_occ == 0))
        self.EHF_def = self.mf_def.e_tot
        self.Eexp = self.EHF_def

        if self.method == "HF":
            self.gamma_ao = self.mf_def.make_rdm1()
            return
        if self.method == "CCSD":
            e_corr, rdm1_mo_g, ghf = _run_gccsd_rdm1(self.mol_def, self.mf_def)
            self.ECCSD_def = e_corr
            self.Eexp = self.EHF_def + e_corr
            # MO G -> AO G -> AO R
            rdm1_ao_g = convert.mo_to_ao(rdm1_mo_g, ghf.mo_coeff)
            self.gamma_ao = convert.convert_g_to_ru_rdm1(rdm1_ao_g)[0]
            return
        if self.method.upper().replace("(", "").replace(")", "") == "CCSDT":
            from ecw_cc_tpu.ops import ccsd_t

            ghf = GHF(self.mf_def)
            eris, vvvv_op, sect, unperm = _build_eris_sorted(self.mol_def,
                                                              ghf)
            t1, t2, e_cc = ccsd_t.solve_ccsd(eris, vvvv_op=vvvv_op,
                                             sect=sect)
            et = float(ccsd_t.energy_t(eris, t1, t2, sect=sect))
            self.ECCSD_def = e_cc
            self.ECCSD_t_def = e_cc + et
            self.Eexp = self.EHF_def + e_cc + et
            rdm1_mo_g = np.asarray(ccsd_t.ccsd_t_rdm1_response(
                eris, t1, t2, vvvv_op=vvvv_op, sect=sect))
            if unperm is not None:
                # back to the alternating-spin MO order of ghf.mo_coeff
                rdm1_mo_g = rdm1_mo_g[np.ix_(unperm, unperm)]
            # symmetrize (the response density of a real functional)
            rdm1_mo_g = 0.5 * (rdm1_mo_g + rdm1_mo_g.T)
            rdm1_ao_g = convert.mo_to_ao(rdm1_mo_g, ghf.mo_coeff)
            self.gamma_ao = convert.convert_g_to_ru_rdm1(rdm1_ao_g)[0]
            return
        raise ValueError("method not recognized (use 'HF', 'CCSD' or 'CCSD(T)')")

    def underfit(self, para_factor, rng=None):
        """Randomly zero elements of gamma_ao to simulate under-fitting.
        Reference gamma_exp.py:257-275."""
        rng = rng or np.random.default_rng()
        dim = self.mo_coeff_def.shape[0]
        n_exp = int(round(dim ** 2 - para_factor * (self.nocc * self.nvir * 2)))
        idx = rng.choice(dim * dim, size=max(n_exp, 0), replace=False)
        flat = self.gamma_ao.ravel().copy()
        flat[idx] = 0.0
        self.gamma_ao = flat.reshape(dim, dim)


class ESexp:
    """ES targets via MOM (delta-SCF). Reference gamma_exp.py:282-488."""

    def __init__(self, mol: Molecule, Vext=None, nbr_of_states=(1, 0)):
        self.mol = mol
        self.mf = RHF(mol)
        self.nbr_of_states = nbr_of_states
        self.gamma_ao = []     # [('val'|'core', rdm1_ao_G), ...]
        self.gamma_tr_ao = []  # [('val'|'core', tdm_ao), ...]
        if Vext is not None:
            h = (mol.intor("kin") + mol.intor("nuc")
                 + np.einsum("x,xij->ij", np.asarray(Vext, float),
                             mol.intor("r", origin=np.zeros(3))))
            self.mf.set_hcore(h)
        self.mf.kernel()
        self.mo_coeff = self.mf.mo_coeff
        self.nocc = int(np.sum(self.mf.mo_occ > 0))
        self.nvir = int(np.sum(self.mf.mo_occ == 0))
        self.Eexp_GS = self.mf.e_tot
        self.DE_exp = []
        self.ini_r = [np.zeros((self.nocc, self.nvir))
                      for _ in range(sum(nbr_of_states))]

    def MOM(self):
        """Delta-SCF (MOM) for valence and core excited states; builds the
        G-format ES rdm1s and biorthogonal Slater transition densities.
        Reference gamma_exp.py:332-462."""
        mol = self.mol
        nao = self.nocc + self.nvir
        homo = mol.nelectron // 2 - 1
        lumo = homo + 1
        mo_coeff_u = np.stack([self.mo_coeff, self.mo_coeff])

        def run_state(occ_a_from, occ_a_to, state_kind, istate):
            moc = np.zeros((2, nao))
            moc[0, : mol.nelec[0]] = 1.0
            moc[1, : mol.nelec[1]] = 1.0
            moc[0, occ_a_from] = 0.0
            moc[0, occ_a_to] = 1.0
            self.ini_r[istate][occ_a_from, occ_a_to - self.nocc] = 1.0

            es_mf = UHF(mol)
            if self.mf._hcore_override is not None:
                es_mf.set_hcore(self.mf._hcore_override)
            dma = (mo_coeff_u[0] * moc[0]) @ mo_coeff_u[0].T
            dmb = (mo_coeff_u[1] * moc[1]) @ mo_coeff_u[1].T
            es_mf.set_mom(mo_coeff_u, moc)
            es_mf.kernel(dm0=(dma, dmb))
            self.DE_exp.append(es_mf.e_tot - self.Eexp_GS)

            uhf_ao = es_mf.make_rdm1()
            ghf_ao = convert.convert_u_to_g_rdm1(uhf_ao)
            self.gamma_ao.append([state_kind, ghf_ao])

            mo_g = convert.convert_r_to_g_coeff(self.mo_coeff)
            es_mo_g = convert.convert_u_to_g_coeff(es_mf.mo_coeff)
            moc_g = convert.convert_u_to_g_moc(moc)
            TcL, TcR = linalg.ortho_SVD(mol, es_mo_g, mo_g)
            tdm = linalg.tdm_slater(TcL, TcR, moc_g)
            self.gamma_tr_ao.append([state_kind, tdm])

        for v in range(self.nbr_of_states[0]):
            run_state(homo, lumo + v, "val", v)
        for c in range(self.nbr_of_states[1]):
            run_state(0, lumo + c, "core", self.nbr_of_states[0] + c)

    def EOM(self, nbr_ES, tol=None):
        """EOM-EE-CCSD excited-state targets (the reference's EOM stub raises,
        gamma_exp.py:464-470; this supplies the intended capability).

        tol: Davidson residual tolerance — default 1e-7 in f64 parity mode,
        1e-5 in f32 production (a tighter tolerance is unreachable in f32:
        Davidson would exhaust max_cycle and report unconverged junk roots).

        Solves plain CCSD + Lambda, then the lowest nbr_ES EOM-EE roots via
        Davidson on the autodiff sigma (ops/eom.py), and builds the MO-G
        left/right transition rdm1s:
          (0,n): <Psi_0(t,Lambda)| ap+ aq |R_k>   (tr_rdm1 with GS left)
          (n,0): <L_k| ap+ aq |Psi_0(t)>          (tr_rdm1 with GS right)
        Results: DE_exp (omegas), gamma_tr_mo [(tr_l_mo, tr_r_mo), ...],
        ini_r (G-format R1 guesses for the ECW ES solver)."""
        from ecw_cc_tpu.ops import ccsd_t
        from ecw_cc_tpu.ops import eom as eom_ops

        from ecw_cc_tpu.config import get_config

        if tol is None:
            tol = 1e-5 if get_config().dtype == "float32" else 1e-7
        ghf = GHF(self.mf)
        # f32 production: spin-sorted build — solve, Lambda, Davidson sigmas
        # and transition rdm1s all run through the sector-blocked kernels;
        # everything handed out is permuted back to the alternating layout
        eris, vvvv_op, sect, unperm = _build_eris_sorted(self.mol, ghf)
        t1, t2, e_cc = ccsd_t.solve_ccsd(eris, vvvv_op=vvvv_op, sect=sect)
        # GS Lambda (textbook equations; plain-CCSD target generation)
        l1, l2 = solve_lambda(eris, t1, t2, vvvv_op=vvvv_op, sect=sect)

        omegas, Rs, Ls = eom_ops.eom_ccsd(eris, t1, t2, nroots=nbr_ES,
                                          tol=tol, left=True,
                                          vvvv_op=vvvv_op, sect=sect)
        nocc = eris.nocc
        if unperm is not None:
            io, iv = unperm[:nocc], unperm[nocc:] - nocc
        self.ECCSD = float(e_cc)
        self.gamma_tr_mo = []
        self.gamma_es_mo = []  # EOM excited-state densities (Tr = N)
        self.spin_labels = []  # singlet/triplet/spin-flip per root
        self.ini_r = []
        self.trdip_exp = []   # [(d_0k, d_k0, oscillator strength), ...]
        dip_int = self.mol.intor("r", origin=self.mol.charge_center())
        for k in range(nbr_ES):
            r1, r2 = Rs[k]
            lk1, lk2 = Ls[k]
            r0 = eom_ops.eom_r0(eris, t1, t2, r1, r2, omegas[k])
            # EXACT Wick-derived transition densities (det-space-validated;
            # the reference's tr_rdm1 formula omits the <0|pq-bar R|0>
            # bra-reference/R coupling).  The trmat targets are stored in
            # the reference index convention (ov/vo blocks transposed
            # relative to <p+ q> — tr_rdm1's own layout, verified equal to
            # the swapped det-space matrices), so they compare consistently
            # with the ES solver's gamma_tr kernels.
            g_r = np.asarray(eom_ops.tr_rdm1_right(
                t1, t2, l1, l2, jnp.asarray(r1), jnp.asarray(r2), r0))
            g_l = np.asarray(eom_ops.tr_rdm1_left(
                t1, t2, jnp.asarray(lk1), jnp.asarray(lk2)))
            tr_l = _swap_ov_vo(g_r, nocc)
            tr_r = _swap_ov_vo(g_l, nocc)
            # excited-state density (biorthogonal; traces to N exactly)
            g_es = _swap_ov_vo(np.asarray(eom_ops.es_rdm1(
                t1, t2, jnp.asarray(lk1), jnp.asarray(lk2),
                jnp.asarray(r1), jnp.asarray(r2), r0)), nocc)
            r1_out = np.asarray(r1)
            if unperm is not None:
                tr_l = tr_l[np.ix_(unperm, unperm)]
                tr_r = tr_r[np.ix_(unperm, unperm)]
                g_es = g_es[np.ix_(unperm, unperm)]
                r1_out = r1_out[np.ix_(io, iv)]
            # canonical phase in the ALTERNATING layout (the module-level
            # canonicalization runs in whatever layout the eris use, so the
            # f32-sorted and f64-dense paths could still disagree): first
            # near-maximal r1 component positive.  tr_l carries R's phase,
            # tr_r carries L's (tied to R by <L|R> = 1) — both flip
            # together; g_es and oscillator strengths are phase-invariant.
            flat = r1_out.ravel()
            aflat = np.abs(flat)
            if aflat.max() > 0 and flat[int(np.argmax(
                    aflat >= 0.999 * aflat.max()))] < 0:
                r1_out = -r1_out
                tr_l = -tr_l
                tr_r = -tr_r
            self.DE_exp.append(float(omegas[k]))
            self.gamma_tr_mo.append((tr_l, tr_r))
            self.gamma_es_mo.append(g_es)
            self.ini_r.append(r1_out)
            self.spin_labels.append(_spin_label(r1_out))
            # transition dipoles + oscillator strength: the biorthogonal
            # product d(0,k).d(k,0) equals |<0|mu|k>|^2 in the FCI limit
            # (norm factors cancel in the product; tested exact for a
            # 2-electron system vs the determinant-space FCI moments)
            dl = props.dipole(self.mol, tr_l, g=True, aobasis=False,
                              mo_coeff=ghf.mo_coeff, dip_int=dip_int)
            dr = props.dipole(self.mol, tr_r, g=True, aobasis=False,
                              mo_coeff=ghf.mo_coeff, dip_int=dip_int)
            f_osc = 2.0 / 3.0 * float(omegas[k]) * float(np.dot(dl, dr))
            self.trdip_exp.append((np.real(dl), np.real(dr), f_osc))
        return omegas
