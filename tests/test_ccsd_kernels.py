"""CCSD kernel validation against the determinant-space (FCI) oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from ecw_cc_tpu.ops import ccsd
from ecw_cc_tpu.utils import convert
from ecw_cc_tpu.oracle import CCOracle
from tests.test_ccs_kernels import _assemble_full_eri


@pytest.fixture(scope="module")
def system(h2_631g):
    mol, ghf, eris_host, eris_dev = h2_631g
    rng = np.random.default_rng(7)
    nocc, nvir = eris_host.nocc, eris_host.nvir
    t1r = rng.random((nocc // 2, nvir // 2)) * 0.1
    t2r = rng.random((nocc // 2, nocc // 2, nvir // 2, nvir // 2)) * 0.1
    # impose the RCCSD permutation symmetry t2[i,j,a,b] = t2[j,i,b,a] so the
    # spin conversion yields a valid antisymmetric spin-orbital t2
    t2r = t2r + t2r.transpose(1, 0, 3, 2)
    t1 = convert.convert_r_to_g_amp(t1r)
    t2 = convert.convert_r_to_g_amp(t2r)
    l1 = 0.5 * t1
    l2 = 0.5 * t2
    f = np.asarray(eris_host.fock)
    eri_full = _assemble_full_eri(eris_host)
    oracle = CCOracle(f, eri_full, nocc)
    return eris_host, eris_dev, oracle, t1, t2, l1, l2, f


def test_t2_antisymmetry_of_conversion(system):
    *_, t2 = system[4], system[4]
    t2 = system[4]
    assert np.allclose(t2, -t2.transpose(1, 0, 2, 3), atol=1e-12)
    assert np.allclose(t2, -t2.transpose(0, 1, 3, 2), atol=1e-12)


def test_ccsd_energy_vs_oracle(system):
    eris_host, eris_dev, oracle, t1, t2, l1, l2, f = system
    hbar = oracle.hbar(t1, t2)
    e_oracle = oracle.energy(hbar)
    e = float(ccsd.energy(eris_dev, jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(f)))
    assert abs(e - e_oracle) < 1e-10


def test_t1t2_equations_vs_oracle(system):
    eris_host, eris_dev, oracle, t1, t2, l1, l2, f = system
    hbar = oracle.hbar(t1, t2)
    res1_o = oracle.t1_residual(hbar, t1)
    res2_o = oracle.doubles_proj(hbar[:, oracle.ref], t1.shape[0], t1.shape[1])
    T1, T2 = ccsd.tupdate(eris_dev, jnp.asarray(t1), jnp.asarray(t2),
                          jnp.asarray(f), equation=True)
    assert np.max(np.abs(np.asarray(T1) - res1_o)) < 1e-9
    assert np.max(np.abs(np.asarray(T2) - res2_o)) < 1e-9


def test_lambda_equations_vs_oracle(system, h2_631g):
    """The PySCF-style Lambda intermediates assume the T equations hold
    (<mu|Hbar|0> = 0), so the residual equals the exact commutator form only
    at converged t — which is the regime the solver uses them in."""
    eris_host, eris_dev, oracle, t1, t2, l1, l2, f = system
    mol, ghf, *_ = h2_631g
    nocc, nvir = t1.shape
    e = ghf.mo_energy
    eia = e[:nocc, None] - e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t1c = jnp.zeros((nocc, nvir))
    t2c = jnp.asarray(eris_host.oovv / eijab)
    for _ in range(80):
        t1c, t2c = ccsd.tupdate(eris_dev, t1c, t2c, None)
    hbar = oracle.hbar(np.asarray(t1c), np.asarray(t2c))
    L1_o = oracle.lambda1_residual(hbar, np.asarray(t1c), l1, l2=l2, commutator=True)
    L1, L2 = ccsd.lupdate(eris_dev, t1c, t2c, jnp.asarray(l1), jnp.asarray(l2),
                          None, equation=True, energy_term="off")
    assert np.max(np.abs(np.asarray(L1) - L1_o)) < 1e-9


def test_plain_ccsd_converges_to_fci_limit(h2_631g):
    """Full CCSD on H2 (2 electrons) must equal FCI: iterate the kernels and
    compare the correlation energy against exact diagonalization."""
    mol, ghf, eris_host, eris_dev = h2_631g
    nocc, nvir = eris_host.nocc, eris_host.nvir
    f = np.asarray(eris_host.fock)
    eri_full = _assemble_full_eri(eris_host)
    oracle = CCOracle(f, eri_full, nocc)
    w = np.linalg.eigvalsh(oracle.H)
    e_fci_corr = w[0] - oracle.E_ref

    # MP2 start (reference Solver_GS.py:557-562)
    e = ghf.mo_energy
    eia = e[:nocc, None] - e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t2 = jnp.asarray(eris_host.oovv / eijab)
    t1 = jnp.zeros((nocc, nvir))
    for _ in range(60):
        t1, t2 = ccsd.tupdate(eris_dev, t1, t2, None)
    e_cc = float(ccsd.energy(eris_dev, t1, t2, None))
    assert abs(e_cc - e_fci_corr) < 1e-9


def test_ccsd_rdm1_trace(system):
    eris_host, eris_dev, oracle, t1, t2, l1, l2, f = system
    g = np.asarray(ccsd.gamma_CCSD(jnp.asarray(t1), jnp.asarray(t2),
                                   jnp.asarray(l1), jnp.asarray(l2)))
    assert abs(np.trace(g) - eris_host.nocc) < 1e-10
    assert np.allclose(g, g.T, atol=1e-12)


def test_tr_rdm1_gs_limit(system):
    """tr_rdm1 with r=0,r0=1 equals the unsymmetrized GS CCSD rdm1 whose trace
    is nelec (Stanton 95 structure)."""
    eris_host, eris_dev, oracle, t1, t2, l1, l2, f = system
    nocc, nvir = t1.shape
    r1 = np.zeros_like(t1)
    r2 = np.zeros_like(t2)
    g = np.asarray(ccsd.tr_rdm1(jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(l1),
                                jnp.asarray(l2), jnp.asarray(r1), jnp.asarray(r2), 1.0))
    # transition rdm1 has no HF diagonal; oo and vv correlation traces cancel
    assert abs(np.trace(g)) < 1e-9
    # and its ov block reduces to l1 (r0=1, r=0)
    assert np.allclose(g[:nocc, nocc:], l1, atol=1e-12)


def test_spin_sector_ladder_exact(h2o_631g):
    """The spin-sector vvvv contraction equals the dense ladder bit-for-bit
    semantics (exact block sparsity, not an approximation)."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ladder

    _, _, _, eris = h2o_631g
    assert ladder.has_spin_structure(eris.vvvv)
    nocc, nvir = eris.nocc, eris.nvir
    rng = np.random.default_rng(7)
    x = rng.standard_normal((nocc, nocc, nvir, nvir))
    x = x - x.transpose(0, 1, 3, 2)   # antisymmetric in (e,f) as t2/l2/tau are
    x = jnp.asarray(x)
    dense = 0.5 * jnp.einsum("ijef,abef->ijab", x, eris.vvvv)
    sect = ladder.sector_vvvv_contract(ladder.vvvv_spin_sectors(eris.vvvv), x)
    assert np.allclose(np.asarray(dense), np.asarray(sect), atol=1e-12)
    # lambda-ladder orientation via pair-swap symmetry
    dense_l = 0.5 * jnp.einsum("ijcd,cdab->ijab", x, eris.vvvv)
    assert np.allclose(np.asarray(dense_l), np.asarray(sect), atol=1e-12)


def test_sectored_ladder_exact(h2o_631g):
    """SectoredVVVV (spin-SORTED layout: sectored + antisymmetry-packed,
    ops/ladder.py) equals the dense ladder exactly, for both the direct and
    stacked t+lambda contractions and the lambda orientation."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ladder

    _, ghf, _, eris = h2o_631g
    nocc, nvir = eris.nocc, eris.nvir
    perm = ladder.spin_sort_perm(ghf.orbspin, nocc)
    pv = perm[nocc:] - nocc
    vs = np.asarray(eris.vvvv)[np.ix_(pv, pv, pv, pv)]     # sorted layout
    ma = int(np.sum(np.asarray(ghf.orbspin)[nocc:][pv] == 0))
    sect = ladder.pack_vvvv_sorted(jnp.asarray(vs), ma)
    # spin-forbidden pair blocks never stored: 2.67x fewer pair-products
    p = nvir * (nvir - 1) // 2
    stored = sect.wc_aa.size + sect.wc_bb.size + sect.w_ab.size
    assert stored < 0.5 * p * p

    rng = np.random.default_rng(13)
    x = rng.standard_normal((nocc, nocc, nvir, nvir))
    x = x - x.transpose(0, 1, 3, 2)
    dense = 0.5 * np.einsum("ijef,abef->ijab", x, vs)
    got = np.asarray(ladder.sectored_vvvv_contract(sect, jnp.asarray(x)))
    assert np.allclose(dense, got, atol=1e-12)
    dense_l = 0.5 * np.einsum("ijcd,cdab->ijab", x, vs)
    assert np.allclose(dense_l, got, atol=1e-12)

    x2 = rng.standard_normal((nocc, nocc, nvir, nvir))
    x2 = x2 - x2.transpose(0, 1, 3, 2)
    y1, y2 = ladder.stacked_sectored_contract(sect, jnp.asarray(x),
                                              jnp.asarray(x2))
    assert np.allclose(dense, np.asarray(y1), atol=1e-12)
    assert np.allclose(0.5 * np.einsum("ijef,abef->ijab", x2, vs),
                       np.asarray(y2), atol=1e-12)


def test_sorted_solver_matches_alternating(h2o_631g):
    """The production while_loop solve on spin-SORTED pack-on-build ERIs
    (SectoredVVVV + Solver_CCSD(mo_perm=...)) returns the SAME public
    (alternating-convention) energies/rdm1/amplitudes as the plain solve —
    f64 exactness, same iteration count."""
    import jax.numpy as jnp
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops import ladder
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris = h2o_631g
    nocc = eris.nocc
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve(sort):
        er, op = build_eris_device(mol, ghf, dtype="float64",
                                   pack_ladder=True, sort_spin=sort)
        if sort:
            assert isinstance(op, ladder.SectoredVVVV)
        perm = ladder.spin_sort_perm(ghf.orbspin, nocc) if sort else None
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        solver = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8,
                             diis="tl", maxiter=60, vvvv_op=op, mo_perm=perm)
        return solver.SCF_device(0.05)

    text_r, Ep_r, _, _, rdm1_r, amps_r = solve(False)
    text_s, Ep_s, _, _, rdm1_s, amps_s = solve(True)
    assert "Convergence reached" in text_s
    assert len(Ep_r) == len(Ep_s)
    assert abs(Ep_r[-1] - Ep_s[-1]) < 1e-10
    assert np.allclose(rdm1_r, rdm1_s, atol=1e-9)
    for a, b in zip(amps_r, amps_s):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-9)


def _sorted_system(h2o_631g):
    import jax.numpy as jnp
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops import ladder
    from ecw_cc_tpu.ops.spinsect import SectorInfo

    mol, ghf, eris_host, _ = h2o_631g
    nocc = eris_host.nocc
    er, sect = build_eris_device(mol, ghf, dtype="float64",
                                 pack_ladder=True, sort_spin=True)
    er_dense = build_eris_device(mol, ghf, dtype="float64", sort_spin=True)
    perm = ladder.spin_sort_perm(ghf.orbspin, nocc)
    spin = np.asarray(ghf.orbspin)[perm]
    info = SectorInfo(int(np.sum(spin[:nocc] == 0)),
                      int(np.sum(spin[:nocc] == 1)),
                      int(np.sum(spin[nocc:] == 0)),
                      int(np.sum(spin[nocc:] == 1)))
    return mol, ghf, er, er_dense, sect, perm, info


def _structured_amps(info, seed=5, scale=0.05):
    import itertools
    from ecw_cc_tpu.ops.spinsect import _balanced, _slices

    rng = np.random.default_rng(seed)
    o, v = info.nocc, info.nvir
    sl = _slices(info)

    def rand(kinds):
        dims = {"o": o, "v": v}
        arr = np.zeros(tuple(dims[k] for k in kinds))
        for key in itertools.product((0, 1), repeat=len(kinds)):
            if _balanced(key):
                idx = tuple(sl[(k, s)] for k, s in zip(kinds, key))
                arr[idx] = rng.standard_normal(arr[idx].shape) * scale
        return arr

    def asym(x):
        x = x - x.transpose(1, 0, 2, 3)
        return 0.5 * (x - x.transpose(0, 1, 3, 2))

    return (rand("ov"), asym(rand("oovv")), rand("ov"), asym(rand("oovv")))


def _mirror_amps(info, seed=11, scale=0.05):
    """Balanced AND exactly spin-flip-symmetric random amplitudes (every
    block equals its alpha<->beta mirror — the closed-shell structure the
    sym kernels assume)."""
    import itertools
    from ecw_cc_tpu.ops.spinsect import _balanced, _flip, _slices

    rng = np.random.default_rng(seed)
    o, v = info.nocc, info.nvir
    sl = _slices(info)

    def rand(kinds):
        dims = {"o": o, "v": v}
        arr = np.zeros(tuple(dims[k] for k in kinds))
        for key in itertools.product((0, 1), repeat=len(kinds)):
            if _balanced(key) and key <= _flip(key):
                idx = tuple(sl[(k, s)] for k, s in zip(kinds, key))
                blk = rng.standard_normal(arr[idx].shape) * scale
                arr[idx] = blk
                arr[tuple(sl[(k, 1 - s)] for k, s in zip(kinds, key))] = blk
        return arr

    def asym(x):
        # antisymmetrization preserves mirror symmetry (axis transposes
        # commute with the global spin flip)
        x = x - x.transpose(1, 0, 2, 3)
        return 0.5 * (x - x.transpose(0, 1, 3, 2))

    return (rand("ov"), asym(rand("oovv")), rand("ov"), asym(rand("oovv")))


def test_sectored_kernels_match_dense(h2o_631g):
    """The sector-blocked t/lambda update twins (ops/ccsd_sect.py) equal
    the dense kernels to machine epsilon — all alpha / energy_term
    variants (the soup's 6.4x dead-FLOP elimination is exact)."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.ops.ccsd_sect import lupdate_sect, tupdate_sect

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    t1, t2, l1, l2 = map(jnp.asarray, _structured_amps(info))
    fsp = er.fock
    for alpha in (None, 0.1):
        t1r, t2r = ccsd_ops.tupdate(er_dense, t1, t2, fsp=fsp, alpha=alpha)
        t1s, t2s = tupdate_sect(er, t1, t2, fsp, info, alpha=alpha,
                                vvvv_op=sect)
        assert np.allclose(np.asarray(t1r), np.asarray(t1s), atol=1e-13)
        assert np.allclose(np.asarray(t2r), np.asarray(t2s), atol=1e-13)
        for eterm in ("ref", "off"):
            l1r, l2r = ccsd_ops.lupdate(er_dense, t1r, t2r, l1, l2, fsp=fsp,
                                        alpha=alpha, energy_term=eterm)
            l1s, l2s = lupdate_sect(er, t1r, t2r, l1, l2, fsp, info,
                                    alpha=alpha, energy_term=eterm,
                                    vvvv_op=sect)
            assert np.allclose(np.asarray(l1r), np.asarray(l1s), atol=1e-13)
            assert np.allclose(np.asarray(l2r), np.asarray(l2s), atol=1e-13)


def test_sectored_soup_solve_matches_dense(h2o_631g):
    """Full production while_loop solve with the sector-blocked soup
    kernels (config.soup_sector) equals the dense-kernel solve bit-for-bit
    semantics at f64 — same iteration count, energies, rdm1, amplitudes."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve(soup_sector):
        old = cfg.get_config().soup_sector
        try:
            cfg.set_config(soup_sector=soup_sector)
            exp = Exp(0.05, [[["mat", target]]], mol=mol,
                      mo_coeff=ghf.mo_coeff)
            sol = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8,
                              diis="tl", maxiter=60, vvvv_op=sect,
                              mo_perm=perm)
            assert sol._vexp_block_diagonal()
            return sol.SCF_device(0.05)
        finally:
            cfg.set_config(soup_sector=old)

    a, b = solve(False), solve(True)
    assert "Convergence reached" in b[0]
    assert len(a[1]) == len(b[1])
    assert abs(a[1][-1] - b[1][-1]) < 1e-12
    assert np.allclose(a[4], b[4], atol=1e-12)
    for x, y in zip(a[5], b[5]):
        assert np.allclose(np.asarray(x), np.asarray(y), atol=1e-12)


def test_sectored_gate_spin_mixing_target(h2o_631g):
    """A target rdm1 with alpha-beta coupling must DISABLE the sectored
    soup (its structure assumption breaks) — the gate detects it and the
    sorted solve still matches the alternating-layout reference solve."""
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    nmo = er.fock.shape[0]
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((nmo, nmo)) * 1e-3
    target = target + 0.5 * (mix + mix.T)   # breaks spin structure

    exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
    sol = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8, diis="tl",
                      maxiter=60, vvvv_op=sect, mo_perm=perm)
    assert not sol._vexp_block_diagonal()
    res_s = sol.SCF_device(0.05)

    er_a, packed = build_eris_device(mol, ghf, dtype="float64",
                                     pack_ladder=True)
    exp_a = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
    sol_a = Solver_CCSD(GCC(er_a), exp_a, conv="tl", conv_thres=1e-8,
                        diis="tl", maxiter=60, vvvv_op=packed)
    res_a = sol_a.SCF_device(0.05)
    assert len(res_s[1]) == len(res_a[1])
    assert abs(res_s[1][-1] - res_a[1][-1]) < 1e-10
    assert np.allclose(res_s[4], res_a[4], atol=1e-9)


def test_sym_kernels_match_dense(h2o_631g):
    """The closed-shell mirror-symmetry kernels (sym=True: only canonical
    spin blocks computed, ops/spinsect.py) equal the dense kernels to
    machine epsilon on mirror-symmetric amplitudes — all alpha /
    energy_term variants."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.ops.ccsd_sect import lupdate_sect, tupdate_sect

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    t1, t2, l1, l2 = map(jnp.asarray, _mirror_amps(info))
    fsp = er.fock
    for alpha in (None, 0.1):
        t1r, t2r = ccsd_ops.tupdate(er_dense, t1, t2, fsp=fsp, alpha=alpha)
        t1s, t2s = tupdate_sect(er, t1, t2, fsp, info, alpha=alpha,
                                vvvv_op=sect, sym=True)
        assert np.allclose(np.asarray(t1r), np.asarray(t1s), atol=1e-13)
        assert np.allclose(np.asarray(t2r), np.asarray(t2s), atol=1e-13)
        for eterm in ("ref", "off"):
            l1r, l2r = ccsd_ops.lupdate(er_dense, t1r, t2r, l1, l2, fsp=fsp,
                                        alpha=alpha, energy_term=eterm)
            l1s, l2s = lupdate_sect(er, t1r, t2r, l1, l2, fsp, info,
                                    alpha=alpha, energy_term=eterm,
                                    vvvv_op=sect, sym=True)
            assert np.allclose(np.asarray(l1r), np.asarray(l1s), atol=1e-13)
            assert np.allclose(np.asarray(l2r), np.asarray(l2s), atol=1e-13)


def test_sym_solve_matches_nonsym(h2o_631g):
    """Full production while_loop solve with config.soup_sym (mirror-
    symmetric kernels + balanced sym ladder) equals the soup_sym=False
    sectored solve at f64 — same iteration count, energies, rdm1,
    amplitudes; both structure gates must pass on the real system."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve(soup_sym):
        old = cfg.get_config().soup_sym
        try:
            cfg.set_config(soup_sym=soup_sym)
            exp = Exp(0.05, [[["mat", target]]], mol=mol,
                      mo_coeff=ghf.mo_coeff)
            sol = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8,
                              diis="tl", maxiter=60, vvvv_op=sect,
                              mo_perm=perm)
            assert sol._vexp_block_diagonal()
            assert sol._spin_restricted()
            return sol.SCF_device(0.05)
        finally:
            cfg.set_config(soup_sym=old)

    a, b = solve(False), solve(True)
    assert "Convergence reached" in b[0]
    assert len(a[1]) == len(b[1])
    assert abs(a[1][-1] - b[1][-1]) < 1e-12
    assert np.allclose(a[4], b[4], atol=1e-12)
    for x, y in zip(a[5], b[5]):
        assert np.allclose(np.asarray(x), np.asarray(y), atol=1e-12)


def test_sym_gate_spin_unrestricted_target(h2o_631g):
    """A spin-block-diagonal target whose alpha block differs from its
    beta block keeps the sectored kernels but must DISABLE the mirror-
    symmetry mode — and the solve still matches the alternating-layout
    reference solve."""
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    nmo = er.fock.shape[0]
    # alpha-only diagonal perturbation in the ORIGINAL (alternating)
    # layout: stays block-diagonal, breaks alpha==beta
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    d = np.zeros(nmo)
    d[0::2] = 1e-3 * np.arange(1, nmo // 2 + 1)
    target = target + np.diag(d)

    exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
    sol = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8, diis="tl",
                      maxiter=60, vvvv_op=sect, mo_perm=perm)
    assert sol._vexp_block_diagonal()
    assert not sol._spin_restricted()
    res_s = sol.SCF_device(0.05)
    assert "Convergence reached" in res_s[0]

    er_a, packed = build_eris_device(mol, ghf, dtype="float64",
                                     pack_ladder=True)
    exp_a = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
    sol_a = Solver_CCSD(GCC(er_a), exp_a, conv="tl", conv_thres=1e-8,
                        diis="tl", maxiter=60, vvvv_op=packed)
    res_a = sol_a.SCF_device(0.05)
    assert len(res_s[1]) == len(res_a[1])
    assert abs(res_s[1][-1] - res_a[1][-1]) < 1e-10
    assert np.allclose(res_s[4], res_a[4], atol=1e-9)


def test_gamma_inter_sect_matches_dense(h2o_631g):
    """The sector-blocked rdm1 intermediates equal the dense gamma_inter /
    gamma_CCSD to machine epsilon (balanced amps; mirror amps for sym)."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.ops.ccsd_sect import gamma_inter_sect

    _, _, _, _, _, _, info = _sorted_system(h2o_631g)
    for amps, sym in ((_structured_amps(info, seed=21), False),
                      (_mirror_amps(info, seed=22), True)):
        t1, t2, l1, l2 = map(jnp.asarray, amps)
        ref = ccsd_ops.gamma_CCSD(t1, t2, l1, l2)
        out = ccsd_ops.gamma_CCSD(
            t1, t2, l1, l2,
            inter=gamma_inter_sect(t1, t2, l1, l2, info, sym=sym))
        assert np.allclose(np.asarray(ref), np.asarray(out), atol=1e-13)


def test_pack_balanced_roundtrip(h2o_631g):
    """The packed DIIS representation (spinsect.pack_balanced) is lossless
    on balanced / mirror-symmetric tensors and its sizes are 37.5% /
    18.75% of dense for 4-index tensors."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops.spinsect import (pack_balanced, packed_size,
                                         unpack_balanced)

    _, _, _, _, _, _, info = _sorted_system(h2o_631g)
    o, v = info.nocc, info.nvir

    t1, t2, _, _ = _structured_amps(info, seed=9)
    for arr, kinds in ((jnp.asarray(t1), "ov"), (jnp.asarray(t2), "oovv")):
        flat = pack_balanced(arr, kinds, info)
        assert flat.shape == (packed_size(kinds, info),)
        assert np.allclose(np.asarray(unpack_balanced(flat, kinds, info)),
                           np.asarray(arr), atol=0)
    assert packed_size("oovv", info) * 16 == 6 * o * o * v * v

    m1, m2, _, _ = _mirror_amps(info, seed=10)
    for arr, kinds in ((jnp.asarray(m1), "ov"), (jnp.asarray(m2), "oovv")):
        flat = pack_balanced(arr, kinds, info, sym=True)
        assert flat.shape == (packed_size(kinds, info, sym=True),)
        assert np.allclose(
            np.asarray(unpack_balanced(flat, kinds, info, sym=True)),
            np.asarray(arr), atol=0)
    assert packed_size("oovv", info, sym=True) * 16 == 3 * o * o * v * v


def test_balanced_ladder_exact(h2o_631g):
    """The balanced-row stacked sectored ladder equals the full-row
    stacked sectored ladder on balanced operands, and its sym mode (skip
    the beta-beta GEMM) is exact on mirror-symmetric operands."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ladder

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    _, x1, _, x2 = map(jnp.asarray, _structured_amps(info, seed=3, scale=1.0))
    r1, r2 = ladder.stacked_sectored_contract(sect, x1, x2)
    b1, b2 = ladder.balanced_stacked_sectored_contract(sect, x1, x2, info.oa)
    assert np.allclose(np.asarray(r1), np.asarray(b1), atol=1e-13)
    assert np.allclose(np.asarray(r2), np.asarray(b2), atol=1e-13)

    _, m1, _, m2 = map(jnp.asarray, _mirror_amps(info, seed=4, scale=1.0))
    r1, r2 = ladder.stacked_sectored_contract(sect, m1, m2)
    s1, s2 = ladder.balanced_stacked_sectored_contract(sect, m1, m2, info.oa,
                                                       sym=True)
    assert np.allclose(np.asarray(r1), np.asarray(s1), atol=1e-13)
    assert np.allclose(np.asarray(r2), np.asarray(s2), atol=1e-13)


def test_packed_ladder_exact(h2o_631g):
    """The antisymmetry-packed vvvv contraction equals the dense ladder for
    any operand antisymmetric in its last two indices (pure antisymmetry —
    no spin-structure requirement)."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ladder

    _, _, _, eris = h2o_631g
    nocc, nvir = eris.nocc, eris.nvir
    rng = np.random.default_rng(11)
    x = rng.standard_normal((nocc, nocc, nvir, nvir))
    x = x - x.transpose(0, 1, 3, 2)
    x = jnp.asarray(x)
    dense = 0.5 * jnp.einsum("ijef,abef->ijab", x, eris.vvvv)
    packed = ladder.packed_vvvv_contract(ladder.pack_vvvv(eris.vvvv), x)
    assert np.allclose(np.asarray(dense), np.asarray(packed), atol=1e-12)
    # lambda-ladder orientation via pair-swap symmetry
    dense_l = 0.5 * jnp.einsum("ijcd,cdab->ijab", x, eris.vvvv)
    assert np.allclose(np.asarray(dense_l), np.asarray(packed), atol=1e-12)


def test_packed_ladder_exact_synthetic_no_spin():
    """Packed route is exact even WITHOUT spin structure (random
    antisymmetrized integrals, where the sector route does not apply)."""
    import jax.numpy as jnp
    import __graft_entry__ as g
    from ecw_cc_tpu.ops import ladder

    eris = g._synthetic_eris(4, 10, np.float64, seed=5)
    assert not ladder.has_spin_structure(eris.vvvv)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 4, 10, 10))
    x = jnp.asarray(x - x.transpose(0, 1, 3, 2))
    dense = 0.5 * jnp.einsum("ijef,abef->ijab", x, eris.vvvv)
    packed = ladder.packed_vvvv_contract(ladder.pack_vvvv(eris.vvvv), x)
    assert np.allclose(np.asarray(dense), np.asarray(packed), atol=1e-12)


def test_tupdate_lupdate_packed_path_matches_dense(h2o_631g):
    """Full t/lambda updates with the packed vvvv_op equal the dense path."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.ops import ladder

    _, ghf, _, eris = h2o_631g
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(np.asarray(eris.fock))
    eia = mo_e[:nocc, None] - mo_e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t2 = jnp.asarray(np.asarray(eris.oovv) / eijab)
    rng = np.random.default_rng(4)
    t1 = jnp.asarray(rng.standard_normal((nocc, nvir)) * 0.01)
    l1, l2 = t1 * 0.5, t2 * 0.5
    packed = ladder.pack_vvvv(eris.vvvv)

    t1d, t2d = ccsd_ops.tupdate(eris, t1, t2)
    t1p, t2p = ccsd_ops.tupdate(eris, t1, t2, vvvv_op=packed)
    assert np.allclose(np.asarray(t1d), np.asarray(t1p), atol=1e-12)
    assert np.allclose(np.asarray(t2d), np.asarray(t2p), atol=1e-12)

    l1d, l2d = ccsd_ops.lupdate(eris, t1, t2, l1, l2)
    l1p, l2p = ccsd_ops.lupdate(eris, t1, t2, l1, l2, vvvv_op=packed)
    assert np.allclose(np.asarray(l1d), np.asarray(l1p), atol=1e-12)
    assert np.allclose(np.asarray(l2d), np.asarray(l2p), atol=1e-12)


def test_spin_structure_detection_rejects_synthetic():
    """Random dense tensors must NOT take the sector path."""
    import __graft_entry__ as g
    from ecw_cc_tpu.ops import ladder

    eris = g._synthetic_eris(4, 8, np.float64)
    assert not ladder.has_spin_structure(eris.vvvv)


def test_tupdate_lupdate_sector_path_matches_dense(h2o_631g):
    """Full t/lambda updates with vvvv_sectors equal the dense-path updates."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.ops import ladder

    _, ghf, _, eris = h2o_631g
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(np.asarray(eris.fock))
    eia = mo_e[:nocc, None] - mo_e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t2 = np.asarray(eris.oovv) / eijab
    rng = np.random.default_rng(3)
    t1 = jnp.asarray(rng.standard_normal((nocc, nvir)) * 0.01)
    t2 = jnp.asarray(t2)
    l1, l2 = t1 * 0.5, t2 * 0.5
    sect = ladder.vvvv_spin_sectors(eris.vvvv)

    t1d, t2d = ccsd_ops.tupdate(eris, t1, t2)
    t1s, t2s = ccsd_ops.tupdate(eris, t1, t2, vvvv_op=sect)
    assert np.allclose(np.asarray(t1d), np.asarray(t1s), atol=1e-12)
    assert np.allclose(np.asarray(t2d), np.asarray(t2s), atol=1e-12)

    l1d, l2d = ccsd_ops.lupdate(eris, t1, t2, l1, l2)
    l1s, l2s = ccsd_ops.lupdate(eris, t1, t2, l1, l2, vvvv_op=sect)
    assert np.allclose(np.asarray(l1d), np.asarray(l1s), atol=1e-12)
    assert np.allclose(np.asarray(l2d), np.asarray(l2s), atol=1e-12)


def test_tupdate_lupdate_soup_views_match_reference_path(h2o_631g):
    """Round-3 soup optimizations — pre-permuted SoupViews (stacked X|Y GEMM,
    m3-kcba and Zl-chain layout dots) and the stacked t+lambda ladder
    (stacked_packed_contract feeding ladder_pre) — are exact restructurings:
    the updates must equal the reference-ordered einsum path to f64
    round-off."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.ops import ladder

    _, ghf, _, eris = h2o_631g
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(np.asarray(eris.fock))
    eia = mo_e[:nocc, None] - mo_e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t2 = jnp.asarray(np.asarray(eris.oovv) / eijab)
    rng = np.random.default_rng(11)
    t1 = jnp.asarray(rng.standard_normal((nocc, nvir)) * 0.01)
    l1, l2 = t1 * 0.5, t2 * 0.5
    packed = ladder.pack_vvvv(eris.vvvv)
    views = ccsd_ops.make_soup_views(eris)
    tau = ccsd_ops.make_tau(t2, t1, t1)
    lad_t, lad_l = ladder.stacked_packed_contract(packed, tau, l2)

    # stacked ladder == two independent packed contracts
    assert np.allclose(np.asarray(lad_t),
                       np.asarray(ladder.packed_vvvv_contract(packed, tau)),
                       atol=1e-12)
    assert np.allclose(np.asarray(lad_l),
                       np.asarray(ladder.packed_vvvv_contract(packed, l2)),
                       atol=1e-12)

    t1d, t2d = ccsd_ops.tupdate(eris, t1, t2)
    t1v, t2v = ccsd_ops.tupdate(eris, t1, t2, vvvv_op=packed, views=views,
                                ladder_pre=lad_t)
    assert np.allclose(np.asarray(t1d), np.asarray(t1v), atol=1e-12)
    assert np.allclose(np.asarray(t2d), np.asarray(t2v), atol=1e-12)

    l1d, l2d = ccsd_ops.lupdate(eris, t1, t2, l1, l2)
    l1v, l2v = ccsd_ops.lupdate(eris, t1, t2, l1, l2, vvvv_op=packed,
                                views=views, ladder_pre=lad_l)
    assert np.allclose(np.asarray(l1d), np.asarray(l1v), atol=1e-12)
    assert np.allclose(np.asarray(l2d), np.asarray(l2v), atol=1e-12)


def test_device_solver_soup_opt_matches_plain(h2o_631g):
    """SCF_device with config.soup_opt on == off (same iterations, same
    fixed point) on the packed pack-on-build route — the production path."""
    import ecw_cc_tpu.config as cfg
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, _ = h2o_631g
    er_p, packed = build_eris_device(mol, ghf, dtype="float64",
                                     pack_ladder=True)
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve():
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        solver = Solver_CCSD(GCC(er_p), exp, conv="tl", conv_thres=1e-8,
                             diis="tl", maxiter=60, vvvv_op=packed)
        return solver.SCF_device(0.05)

    old = cfg.get_config().soup_opt
    try:
        cfg.set_config(soup_opt=True)
        text_a, Ep_a, _, _, rdm1_a, amps_a = solve()
        cfg.set_config(soup_opt=False)
        text_b, Ep_b, _, _, rdm1_b, amps_b = solve()
    finally:
        cfg.set_config(soup_opt=old)
    assert "Convergence reached" in text_a
    assert len(Ep_a) == len(Ep_b)
    assert abs(Ep_a[-1] - Ep_b[-1]) < 1e-10
    assert np.allclose(rdm1_a, rdm1_b, atol=1e-9)
    for a, b in zip(amps_a, amps_b):
        assert np.allclose(a, b, atol=1e-9)


@pytest.mark.parametrize("mode", ["kconcat", "flip", "kconcat+flip"])
def test_soup_gemm_modes_exact(h2o_631g, mode):
    """The sector-GEMM emission schemes (config.soup_gemm: 'kconcat' sums
    spin-sector contributions into one dot with
    concatenated contraction axes; 'flip' streams the larger free dim as
    the GEMM M) are EXACT rewrites of the r3 per-assignment emission: the
    full sector-blocked t/lambda updates agree with 'sep' to 1e-12."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.ops.ccsd_sect import lupdate_sect, tupdate_sect
    from ecw_cc_tpu.ops.ladder import balanced_stacked_sectored_contract

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    t1, t2, l1, l2 = map(jnp.asarray, _mirror_amps(info, seed=21))

    def run():
        lad_t, lad_l = balanced_stacked_sectored_contract(
            sect, t2, l2, info.oa, sym=True)
        t1n, t2n = tupdate_sect(er, t1, t2, er.fock, info,
                                ladder_pre=lad_t, sym=True)
        l1n, l2n = lupdate_sect(er, t1, t2, l1, l2, er.fock, info,
                                ladder_pre=lad_l, sym=True)
        return [np.asarray(x) for x in (t1n, t2n, l1n, l2n)]

    ref = run()
    try:
        cfg.set_config(soup_gemm=mode)
        out = run()
    finally:
        cfg.set_config(soup_gemm="sep")
    for r, o in zip(ref, out):
        assert np.max(np.abs(r - o)) < 1e-12 * max(1.0, np.max(np.abs(r)))


@pytest.mark.parametrize("sym", [False, True])
def test_blocked_ladder_route_matches_dense(h2o_631g, sym):
    """The r5 blocked production route — blocked tau (_tau_b) fed straight
    into the balanced stacked ladder (blocked_info=...), SpinBlocked
    ladder_pre into the update tails (blocked m3, per-block e_ijab divide,
    per-block energy term) — equals the r4 dense-assembled path to f64
    round-off.  This is the exact composition gs.py/bench.py emit."""
    import jax.numpy as jnp
    from ecw_cc_tpu.ops.ccsd import make_tau
    from ecw_cc_tpu.ops.ccsd_sect import _tau_b, lupdate_sect, tupdate_sect
    from ecw_cc_tpu.ops.ladder import balanced_stacked_sectored_contract
    from ecw_cc_tpu.ops.spinsect import wrap

    mol, ghf, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    amps = _mirror_amps(info, seed=31) if sym else \
        _structured_amps(info, seed=31)
    t1, t2, l1, l2 = map(jnp.asarray, amps)
    fsp = er.fock

    # r4 path: dense tau, dense-assembled ladder
    tau_d = make_tau(t2, t1, t1)
    lt_d, ll_d = balanced_stacked_sectored_contract(
        sect, tau_d, l2, info.oa, sym=sym)
    a1, a2 = tupdate_sect(er, t1, t2, fsp, info, ladder_pre=lt_d, sym=sym)
    c1, c2 = lupdate_sect(er, t1, t2, l1, l2, fsp, info, ladder_pre=ll_d,
                          sym=sym)

    # r5 path: blocked tau shared by ladder rows + tupdate, blocked tails
    tau_b = _tau_b(wrap(t2, "oovv", info, sym=sym),
                   wrap(t1, "ov", info, sym=sym))
    lt_b, ll_b = balanced_stacked_sectored_contract(
        sect, tau_b, l2, info.oa, sym=sym, blocked_info=info)
    assert np.max(np.abs(np.asarray(lt_b.dense() - lt_d))) < 1e-13
    assert np.max(np.abs(np.asarray(ll_b.dense() - ll_d))) < 1e-13
    b1, b2 = tupdate_sect(er, t1, t2, fsp, info, ladder_pre=lt_b, sym=sym,
                          tau_pre=tau_b)
    d1, d2 = lupdate_sect(er, t1, t2, l1, l2, fsp, info, ladder_pre=ll_b,
                          sym=sym)
    for r, o in ((a1, b1), (a2, b2), (c1, d1), (c2, d2)):
        assert np.max(np.abs(np.asarray(r - o))) < \
            1e-13 * max(1.0, float(np.max(np.abs(np.asarray(r)))))
