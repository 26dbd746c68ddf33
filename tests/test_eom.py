"""EOM-EE-CCSD (autodiff sigma) tests.

The reference's EOM target generator is an unimplemented stub
(gamma_exp.py:464-470); ops/eom.py supplies the intended capability.
Oracle: for a 2-electron system CCSD is FCI, so EOM-CCSD excitation
energies must equal exact FCI excitation energies (determinant-space H)."""

import numpy as np
import jax.numpy as jnp

from ecw_cc_tpu.oracle import CCOracle
from ecw_cc_tpu.ops import ccsd_t
from ecw_cc_tpu.ops import eom
from tests.test_ccs_kernels import _assemble_full_eri


def test_eom_ccsd_equals_fci_for_two_electrons(h2_631g):
    mol, ghf, eris_host, eris = h2_631g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris)

    omegas, Rs = eom.eom_ccsd(eris, t1, t2, nroots=3, tol=1e-9)

    eri_full = _assemble_full_eri(eris_host)
    oracle = CCOracle(np.asarray(eris_host.fock), eri_full, eris.nocc)
    w = np.sort(np.linalg.eigvalsh(oracle.H))
    exc = w[1:] - w[0]
    for om in omegas:
        assert om > 0
        assert np.min(np.abs(exc - om)) < 1e-7, (om, exc[:6])


def test_eom_left_right_biorthogonal(h2o_sto3g):
    mol, ghf, eris_host, eris = h2o_sto3g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris)
    omegas, Rs, Ls = eom.eom_ccsd(eris, t1, t2, nroots=2, tol=1e-8, left=True)
    assert omegas[0] > 0 and omegas[1] >= omegas[0] - 1e-10
    for k in range(2):
        ov = (np.vdot(Ls[k][0], Rs[k][0])
              + 0.25 * np.vdot(Ls[k][1], Rs[k][1]))
        assert abs(ov - 1.0) < 1e-6  # biorthonormalized (physical product)
        # left really solves the transposed problem (restricted to the
        # antisymmetric subspace): P A^T L = w L — on the RAW vector
        # (l1, l2/4); returned Ls are metric-corrected operator amplitudes
        sigma, sigma_left = eom.make_sigma(eris, t1, t2)
        s1, s2 = sigma_left(jnp.asarray(Ls[k][0]),
                            jnp.asarray(Ls[k][1] / 4.0))
        s2 = np.asarray(s2)
        s2 = 0.25 * (s2 - s2.transpose(1, 0, 2, 3)
                     - s2.transpose(0, 1, 3, 2) + s2.transpose(1, 0, 3, 2))
        r = np.concatenate([np.asarray(s1).ravel(), s2.ravel()])
        l = np.concatenate([Ls[k][0].ravel(), (Ls[k][1] / 4.0).ravel()])
        assert np.linalg.norm(r - omegas[k] * l) < 1e-5 * np.linalg.norm(l)


def test_eom_transition_dipole_equals_fci_for_two_electrons(h2_631g):
    """Biorthogonal product of EOM-EE left/right transition dipoles equals
    the exact FCI |<0|mu|k>|^2 for a 2-electron system (norm factors cancel
    in the product)."""
    from ecw_cc_tpu.models.gamma_exp import solve_lambda
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.utils import props

    mol, ghf, eris_host, eris = h2_631g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris, conv_tol=1e-13)
    l1, l2 = solve_lambda(eris, t1, t2, conv_tol=1e-12)
    omegas, Rs, Ls = eom.eom_ccsd(eris, t1, t2, nroots=4, tol=1e-9,
                                  left=True)

    dip_int = mol.intor("r", origin=mol.charge_center())
    fs = []
    for k in range(len(omegas)):
        r1, r2 = map(jnp.asarray, Rs[k])
        e1, e2 = map(jnp.asarray, Ls[k])
        r0 = eom.eom_r0(eris, t1, t2, r1, r2, omegas[k])
        tr_l = np.asarray(eom.tr_rdm1_right(t1, t2, l1, l2, r1, r2, r0))
        tr_r = np.asarray(eom.tr_rdm1_left(t1, t2, e1, e2))
        # cross-check: the reference-convention formula (pure-L bra) is
        # the ov/vo-swapped det-space matrix
        tr_r_ref = np.asarray(ccsd_ops.tr_rdm1_left(t1, t2, e1, e2))
        swp = tr_r.copy()
        no = t1.shape[0]
        swp[:no, no:] = tr_r[no:, :no].T
        swp[no:, :no] = tr_r[:no, no:].T
        assert np.max(np.abs(swp - tr_r_ref)) < 1e-10
        dl = props.dipole(mol, tr_l, g=True, aobasis=False,
                          mo_coeff=ghf.mo_coeff, dip_int=dip_int)
        dr = props.dipole(mol, tr_r, g=True, aobasis=False,
                          mo_coeff=ghf.mo_coeff, dip_int=dip_int)
        fs.append(float(np.real(np.dot(dl, dr))))

    # exact FCI moments in the determinant space
    eri_full = _assemble_full_eri(eris_host)
    oracle = CCOracle(np.asarray(eris_host.fock), eri_full, eris.nocc)
    w, V = np.linalg.eigh(oracle.H)
    nao = mol.nao
    C = ghf.mo_coeff
    M_ops = []
    for x in range(3):
        mu_g = np.zeros((2 * nao, 2 * nao))
        mu_g[:nao, :nao] = dip_int[x]
        mu_g[nao:, nao:] = dip_int[x]
        M_ops.append(oracle.space.op_matrix_1e(C.T @ mu_g @ C))
    v0 = V[:, 0]
    checked = 0
    for k, om in enumerate(omegas):
        idx = np.where(np.abs((w - w[0]) - om) < 1e-7)[0]
        if len(idx) != 1:
            continue  # degenerate FCI level: single-root moment not defined
        vk = V[:, idx[0]]
        f_fci = sum(float(v0 @ M @ vk) ** 2 for M in M_ops)
        assert abs(fs[k] - f_fci) < 1e-7, (k, om, fs[k], f_fci)
        checked += 1
    assert checked >= 1
    assert max(map(abs, fs)) > 1e-3  # at least one dipole-allowed root


def test_es_rdm1_detspace_and_trace(h2_631g):
    """EOM-EE excited-state density: equals the det-space contraction
    <0|L pq-bar (r0+R)|0> elementwise at the converged point, and traces
    to the electron number for biorthonormal L/R."""
    from ecw_cc_tpu.oracle import cluster_matrices

    mol, ghf, eris_host, eris = h2_631g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris, conv_tol=1e-13)
    omegas, Rs, Ls = eom.eom_ccsd(eris, t1, t2, nroots=2, tol=1e-10,
                                  left=True)
    k = 0
    r1, r2 = np.asarray(Rs[k][0]), np.asarray(Rs[k][1])
    e1, e2 = np.asarray(Ls[k][0]), np.asarray(Ls[k][1])
    r0 = eom.eom_r0(eris, t1, t2, jnp.asarray(r1), jnp.asarray(r2),
                    omegas[k])
    g = np.asarray(eom.es_rdm1(t1, t2, jnp.asarray(e1), jnp.asarray(e2),
                               jnp.asarray(r1), jnp.asarray(r2), r0))
    nocc = eris.nocc
    assert abs(np.trace(g) - nocc) < 1e-8

    nmo = eris.fock.shape[0]
    space, U, Uinv = cluster_matrices(nmo, nocc, nocc, np.asarray(t1),
                                      np.asarray(t2))
    ref = space.index[(1 << nocc) - 1]
    e0 = np.zeros(space.dim)
    e0[ref] = 1.0

    def exc_vec(x1, x2, x0):
        v = x0 * e0.copy()
        for i in range(nocc):
            for a in range(nmo - nocc):
                if x1[i, a] != 0:
                    v = v + x1[i, a] * (
                        space.excitation_matrix(nocc + a, i) @ e0)
        for i in range(nocc):
            for j in range(nocc):
                for a in range(nmo - nocc):
                    for b in range(nmo - nocc):
                        if x2[i, j, a, b] != 0:
                            Ea = space.excitation_matrix(nocc + a, i)
                            Eb = space.excitation_matrix(nocc + b, j)
                            v = v + 0.25 * x2[i, j, a, b] * (Ea @ (Eb @ e0))
        return v

    # bra <0|L: de-excitation operators applied leftward == the transpose
    # of the excitation map on the bra side
    L1m = np.zeros((nmo, nmo))
    L1m[:nocc, nocc:] = e1
    op1 = space.op_matrix_1e(L1m)
    E4 = np.zeros((nmo,) * 4)
    E4[:nocc, :nocc, nocc:, nocc:] = e2
    op2 = space.op_matrix_2e(E4)
    braL = op1.T @ e0 + op2.T @ e0
    ketR = U @ exc_vec(r1, r2, r0)
    for p in range(nmo):
        for q in range(nmo):
            Epq = np.zeros((nmo, nmo))
            Epq[p, q] = 1.0
            val = braL @ (Uinv @ (space.op_matrix_1e(Epq) @ ketR))
            assert abs(val - g[p, q]) < 1e-8, (p, q, val, g[p, q])


def test_build_es_exp_eom(h2o_sto3g):
    from ecw_cc_tpu import ECW

    ecw = ECW("h2o", "sto-3g")
    ecw.Build_ES_exp_EOM(1)
    assert len(ecw.exp_data) == 2
    assert ecw.exp_data[1][0][0] == "trmat"
    tr_l, tr_r = ecw.exp_data[1][0][1]
    dim = 2 * ecw.mol.nao
    assert tr_l.shape == (dim, dim) and tr_r.shape == (dim, dim)
    # left and right transition densities genuinely differ (non-symmetric)
    assert not np.allclose(tr_l, tr_r)
    de = ecw.Eexp_ES[0][0]
    assert 0.2 < de < 1.0  # H2O/STO-3G lowest excitation ~ 0.3-0.5 au
    nocc = int(np.sum(ecw.mo_occ > 0))
    assert len(ecw.r_ini) == 1
    assert ecw.r_ini[0].shape == (nocc, dim - nocc)


def test_build_es_exp_eom_trdip(h2o_sto3g):
    from ecw_cc_tpu import ECW

    ecw = ECW("h2o", "sto-3g")
    ecw.Build_ES_exp_EOM(1, prop="trdip")
    assert ecw.exp_data[1][0][0] == "trdip"
    d = ecw.exp_data[1][0][1]
    assert len(d) == 3 and all(np.isfinite(d))
    assert len(ecw.f_osc_ES) == 1 and np.isfinite(ecw.f_osc_ES[0])

    ecw2 = ECW("h2o", "sto-3g")
    ecw2.Build_ES_exp_EOM(2, prop="mat")
    assert ecw2.exp_data[1][0][0] == "mat"
    g = ecw2.exp_data[1][0][1]
    assert abs(np.trace(g) - ecw2.mol.nelectron) < 1e-6
    # spin classification: lowest H2O root is a triplet (f = 0), and
    # triplet roots carry no oscillator strength
    assert ecw2.spin_ES[0] == "triplet"
    for lab, f in zip(ecw2.spin_ES, ecw2.f_osc_ES):
        if lab == "triplet":
            assert abs(f) < 1e-8


def test_eom_packed_ladder_matches_dense(h2o_sto3g):
    """vvvv_op threading (pack-on-build ERIs for ES/EOM target
    generation): the packed ladder inside the autodiff sigma must
    reproduce the dense omegas AND the dense left eigenvectors — the vjp
    transpose of the packed route is only equivalent under the mv_left
    output antisymmetrization (see make_sigma docstring)."""
    from ecw_cc_tpu.ops import ladder

    mol, ghf, eris_host, eris = h2o_sto3g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris)
    packed = ladder.pack_vvvv(eris.vvvv)
    om_d, Rs_d, Ls_d = eom.eom_ccsd(eris, t1, t2, nroots=2, tol=1e-9,
                                    left=True)
    om_p, Rs_p, Ls_p = eom.eom_ccsd(eris, t1, t2, nroots=2, tol=1e-9,
                                    left=True, vvvv_op=packed)
    assert np.allclose(om_d, om_p, atol=1e-8)
    for k in range(2):
        for a, b in zip(Rs_d[k] + Ls_d[k], Rs_p[k] + Ls_p[k]):
            # eigenvectors defined up to sign
            s = np.sign(np.vdot(a.ravel(), b.ravel()))
            assert np.allclose(a, s * b, atol=1e-6)


def test_eom_sectored_matches_dense(h2o_sto3g):
    """Every EOM-EE root from the sector-blocked sigma (sorted layout)
    appears in the dense-sigma spectrum: on the spin-balanced (Sz=0)
    subspace the sectored and dense Jacobians agree exactly.  The sectored
    Davidson additionally SKIPS the degenerate Ms=+-1 spin-flip copies of
    triplet roots (they live in the off-balance sector the projection
    annihilates), so it yields distinct EE states where the dense run
    repeats a multiplet — compare as a subset, not elementwise."""
    from test_ccsd_kernels import _sorted_system
    from ecw_cc_tpu.ops.ladder import pack_vvvv_sorted

    _, _, _, er_dense, _, _, info = _sorted_system(h2o_sto3g)
    vop = pack_vvvv_sorted(er_dense.vvvv, info.va)
    t1, t2, _ = ccsd_t.solve_ccsd(er_dense, conv_tol=1e-11)
    w_d, _ = eom.eom_ccsd(er_dense, t1, t2, nroots=5, tol=1e-9)
    w_s, Rs_s = eom.eom_ccsd(er_dense, t1, t2, nroots=2, tol=1e-9,
                             vvvv_op=vop, sect=(info, True))
    assert w_s[1] - w_s[0] > 1e-4  # distinct states, no multiplet repeats
    for ws in w_s:
        assert np.min(np.abs(np.asarray(w_d) - ws)) < 1e-8, (ws, w_d)
    for _, r2s in Rs_s:
        # iterates stayed in the balanced subspace (hard zeros off-balance)
        oa, va = info.oa, info.va
        assert np.max(np.abs(np.asarray(r2s)[:oa, :oa, va:, va:])) < 1e-12


def test_es_exp_eom_f32_sorted_matches_f64():
    """The f32 production ESexp.EOM (spin-sorted build, sectored sigmas,
    balance-projected Davidson, dtype-aware tol) reproduces the f64
    dense-path omegas and transition rdm1s, permuted back to the
    alternating layout."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.models.gamma_exp import ESexp
    from ecw_cc_tpu.models.molecule import Molecule

    e64 = ESexp(Molecule("h2o", "sto-3g"))
    e64.mf.kernel()
    w64 = e64.EOM(2)
    old = cfg.get_config().dtype
    try:
        cfg.set_config(dtype="float32")
        e32 = ESexp(Molecule("h2o", "sto-3g"))
        e32.mf.kernel()
        w32 = e32.EOM(2)
    finally:
        cfg.set_config(dtype=old)
    assert np.allclose(w64, w32, atol=1e-5)
    for k in range(2):
        for s in (0, 1):
            assert np.max(np.abs(e64.gamma_tr_mo[k][s]
                                 - e32.gamma_tr_mo[k][s])) < 1e-5


def test_eom_f32_roots_match_f64():
    """f32 production EOM (r4 spurious-root fix):
    ESexp.EOM in f32 must find the SAME lowest EE roots as f64, not the
    structural-null-space junk an unprojected f32 Davidson converges to
    (regression: w32 was [~0, ~0, 0.281] instead of [0.281, 0.308, 0.363]
    before the candidate-direction projector in utils/linalg).  Pins the
    documented f32 error bar: |dw| <= 2e-5 au on excitation energies."""
    import jax

    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.models.gamma_exp import ESexp
    from ecw_cc_tpu.models.molecule import Molecule

    def run():
        es = ESexp(Molecule("h2o", "6-31g"))
        es.EOM(3)
        return np.asarray(es.DE_exp, dtype=np.float64)

    w64 = run()
    old_x64 = jax.config.jax_enable_x64
    try:
        cfg.set_config(dtype="float32")
        jax.config.update("jax_enable_x64", False)
        w32 = run()
    finally:
        jax.config.update("jax_enable_x64", old_x64)
        cfg.set_config(dtype="float64")
    assert np.max(np.abs(w64 - w32)) < 2e-5, (w64, w32)
