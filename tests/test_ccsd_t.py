"""CCSD(T) energy + response-density tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from ecw_cc_tpu.ops import ccsd_t, ccsd as ccsd_ops


def test_t_zero_for_two_electrons(h2_631g):
    """(T) vanishes identically for a 2-electron system (no triples)."""
    mol, ghf, eris_host, eris_dev = h2_631g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris_dev)
    et = float(ccsd_t.energy_t(eris_dev, t1, t2))
    assert abs(et) < 1e-12


@pytest.fixture(scope="module")
def h2o_system(h2o_sto3g):
    mol, ghf, eris_host, eris_dev = h2o_sto3g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris_dev)
    return eris_dev, t1, t2, e_cc


def test_t_energy_sign_and_magnitude(h2o_system):
    """(T) is a small negative correction for H2O near equilibrium."""
    eris, t1, t2, e_cc = h2o_system
    et = float(ccsd_t.energy_t(eris, t1, t2))
    assert -5e-3 < et < 0.0


def test_t3_antisymmetry(h2o_system):
    eris, t1, t2, e_cc = h2o_system
    t3c, t3d, D, w = ccsd_t._t3_pieces(eris, t1, t2, None)
    t3c = np.asarray(t3c)
    assert np.allclose(t3c, -t3c.transpose(1, 0, 2, 3, 4, 5), atol=1e-10)
    assert np.allclose(t3c, -t3c.transpose(0, 2, 1, 3, 4, 5), atol=1e-10)
    assert np.allclose(t3c, -t3c.transpose(0, 1, 2, 4, 3, 5), atol=1e-10)
    assert np.allclose(t3c, -t3c.transpose(0, 1, 2, 3, 5, 4), atol=1e-10)


def test_response_density_finite_difference(h2o_system, h2o_sto3g):
    """The adjoint-computed CCSD(T) density is the exact derivative of the
    converged E_CCSD(T) w.r.t. the one-body matrix (frozen orbitals):
        Tr(gamma_corr A) == d/de E(f + e A)  at e -> 0."""
    eris, t1, t2, e_cc = h2o_system
    mol, ghf, eris_host, _ = h2o_sto3g
    nocc, nvir = t1.shape
    dim = nocc + nvir

    gamma = np.asarray(ccsd_t.ccsd_t_rdm1_response(eris, t1, t2))
    rng = np.random.default_rng(5)
    A = rng.standard_normal((dim, dim)) * 0.5
    A = A + A.T

    def etot(eps):
        f = jnp.asarray(np.asarray(eris.fock) + eps * A)
        # re-solve amplitudes at perturbed f (frozen MOs)
        t1p, t2p = jnp.zeros_like(t1), t2
        t1p, t2p = t1, t2
        e_old = 0.0
        for _ in range(300):
            t1p, t2p = ccsd_ops.tupdate(eris, t1p, t2p, fsp=f)
            e_now = float(ccsd_ops.energy(eris, t1p, t2p, f))
            if abs(e_now - e_old) < 1e-12:
                break
            e_old = e_now
        return (float(ccsd_ops.energy(eris, t1p, t2p, f))
                + float(ccsd_t.energy_t(eris, t1p, t2p, f))
                + float(jnp.einsum("pq,qp", f, jnp.diag(
                    jnp.concatenate([jnp.ones(nocc), jnp.zeros(nvir)])))))

    eps = 2e-5
    deriv_fd = (etot(eps) - etot(-eps)) / (2 * eps)
    deriv_an = np.einsum("pq,qp", A, gamma)
    assert abs(deriv_fd - deriv_an) < 1e-6


def test_gexp_ccsd_t_target():
    """Gexp builds a CCSD(T) target density end to end."""
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.models.gamma_exp import Gexp

    mol = Molecule("h2o", "sto-3g")
    gexp = Gexp(mol, "CCSD(T)")
    gexp.build()
    g = gexp.gamma_ao
    S = mol.intor("ovlp")
    assert abs(np.einsum("ij,ji", g, S) - mol.nelectron) < 1e-6
    assert gexp.Eexp < gexp.EHF_def  # correlation lowers the energy


def test_energy_t_scan_matches_dense(h2o_sto3g):
    """The (i,j)-pair-scanned (T) energy (O(o v^3) memory) equals the dense
    full-t3 evaluation."""
    from ecw_cc_tpu.ops import ccsd_t

    _, _, _, eris = h2o_sto3g
    t1, t2, e_cc = ccsd_t.solve_ccsd(eris)
    e_dense = float(ccsd_t._energy_t_dense(eris, t1, t2))
    e_scan = float(ccsd_t.energy_t(eris, t1, t2))
    assert abs(e_dense - e_scan) < 1e-12
    assert e_scan < 0  # (T) lowers the energy for a normal closed shell


def test_response_density_packed_ladder_matches_dense(h2o_system):
    """ccsd_t_rdm1_response with a packed vvvv_op (pack-on-build target
    generation) must equal the dense-path density: the
    packed and dense update maps share the same antisymmetric fixed-point
    branch, so the implicit adjoint gradient is identical."""
    from ecw_cc_tpu.ops import ladder

    eris, t1, t2, e_cc = h2o_system
    packed = ladder.pack_vvvv(eris.vvvv)
    g_d = np.asarray(ccsd_t.ccsd_t_rdm1_response(eris, t1, t2))
    g_p = np.asarray(ccsd_t.ccsd_t_rdm1_response(eris, t1, t2,
                                                 vvvv_op=packed))
    assert np.max(np.abs(g_d - g_p)) < 1e-9


def test_target_generation_never_builds_dense_vvvv():
    """In the f32 production mode every target-generation path builds
    pack-on-build ERIs: the GEris carries the (nvir,0,0,0) placeholder and
    the dense v^4 block is never materialized."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.models.gamma_exp import _build_eris_auto
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.models.scf import RHF, GHF
    from ecw_cc_tpu.ops.ladder import PackedVVVV

    mol = Molecule("h2o", "sto-3g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    old = cfg.get_config().dtype
    try:
        cfg.set_config(dtype="float32")
        eris, vvvv_op = _build_eris_auto(mol, ghf)
    finally:
        cfg.set_config(dtype=old)
    assert eris.vvvv.size == 0
    assert isinstance(vvvv_op, PackedVVVV)


def test_energy_t_sect_matches_dense(h2o_631g):
    """The spin-sector-blocked (T) energy (energy_t_sect, sorted layout)
    equals the dense pair-scan on balanced amplitudes; sym=True equals it
    on mirror-symmetric amplitudes (spin-restricted eris)."""
    from test_ccsd_kernels import (_sorted_system, _structured_amps,
                                   _mirror_amps)
    from ecw_cc_tpu.ops.ccsd_t import (energy_t, energy_t_sect,
                                       eris_spin_restricted)

    _, _, _, er_dense, _, _, info = _sorted_system(h2o_631g)
    assert eris_spin_restricted(er_dense, info)
    for amps, sym in ((_structured_amps(info, seed=31), False),
                      (_mirror_amps(info, seed=32), True)):
        t1, t2, _, _ = map(jnp.asarray, amps)
        ref = float(energy_t(er_dense, t1, t2))
        out = float(energy_t_sect(er_dense, t1, t2, info, sym=sym))
        assert abs(ref - out) < 1e-11 * max(1.0, abs(ref))


def test_response_density_sect_matches_dense(h2o_631g):
    """ccsd_t_rdm1_response with the sector-blocked (T) (sect=(info, sym))
    equals the dense-path density: the sectored energy's t-gradient only
    zeroes components that vanish by spin conservation at a balanced
    amplitude point, and its f-dependence (diag only) is untouched."""
    from test_ccsd_kernels import _sorted_system
    from ecw_cc_tpu.ops import ccsd_t

    _, _, _, er_dense, _, _, info = _sorted_system(h2o_631g)
    t1, t2, _ = ccsd_t.solve_ccsd(er_dense, conv_tol=1e-11)
    g_ref = np.asarray(ccsd_t.ccsd_t_rdm1_response(er_dense, t1, t2))
    g_sec = np.asarray(ccsd_t.ccsd_t_rdm1_response(er_dense, t1, t2,
                                                   sect=(info, True)))
    assert np.max(np.abs(g_ref - g_sec)) < 1e-7


def test_gexp_f32_sorted_target_matches_f64():
    """The f32 production target build (_build_eris_sorted: spin-sorted
    layout, sectored+sym t/lambda solves, sectored rdm1, permuted back)
    reproduces the f64 dense-path CCSD target density and energy."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.models.gamma_exp import Gexp
    from ecw_cc_tpu.models.molecule import Molecule

    g64 = Gexp(Molecule("h2o", "sto-3g"), "CCSD")
    g64.build()
    old = cfg.get_config().dtype
    try:
        cfg.set_config(dtype="float32")
        g32 = Gexp(Molecule("h2o", "sto-3g"), "CCSD")
        g32.build()
    finally:
        cfg.set_config(dtype=old)
    assert abs(g64.Eexp - g32.Eexp) < 1e-6
    assert np.max(np.abs(g64.gamma_ao - g32.gamma_ao)) < 1e-5


def test_energy_t_bf16_slab_error_bound(h2o_631g):
    """Reduced-precision (T): with bf16 SLABS and
    full-precision denominators/accumulation, the sectored (T) energy
    matches the exact value to a documented 5e-3 RELATIVE bound (the slab
    rounding is ~4e-3 per element and largely averages out across the
    o^2 v^3 terms; measured here ~1e-3 rel at H2O/6-31G).  The bound is
    the contract bench.py's t row and target generation rely on."""
    from test_ccsd_kernels import _sorted_system, _mirror_amps
    from ecw_cc_tpu.ops.ccsd_t import energy_t, energy_t_sect

    _, _, _, er_dense, _, _, info = _sorted_system(h2o_631g)
    t1, t2, _, _ = map(jnp.asarray, _mirror_amps(info, seed=33))
    ref = float(energy_t(er_dense, t1, t2))
    for sym in (False, True):
        out = float(energy_t_sect(er_dense, t1, t2, info, sym=sym,
                                  slab_dtype="bfloat16"))
        assert abs(out - ref) < 5e-3 * max(abs(ref), 1e-6), (sym, ref, out)
