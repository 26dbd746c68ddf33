"""End-to-end ground-state tests through the ECW driver.

Anchors (reference values):
  - doctest run (reference __init__.py:9-40): h2o/6-31g, 'mat' target from
    HF + field [0.05, 0.01, 0], L = 0.5 -> EHF = -75.9839, Eexp = -75.9860,
    Ep = -75.9840, converged after 8 iterations.
  - ECW-CCSD at L=0 equals plain CCSD (reference Solver_GS.py:885).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ecw_cc_tpu import ECW
from ecw_cc_tpu.ops import ccsd as ccsd_ops


@pytest.fixture(scope="module")
def ecw_h2o():
    ecw = ECW("h2o", "6-31g")
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    return ecw


def test_doctest_anchors(ecw_h2o):
    ecw = ecw_h2o
    assert abs(ecw.EHF - (-75.9839)) < 1e-3
    assert abs(ecw.Eexp_GS - (-75.9860)) < 1e-3
    res = ecw.CCS_GS(np.linspace(0.5, 0.5, 1))
    assert "Convergence reached" in res[0]
    assert "after 8 iteration" in res[0]
    Ep_tot = res[1][-1] + ecw.EHF
    assert abs(Ep_tot - (-75.9840)) < 5e-4


def test_host_device_solver_parity(ecw_h2o):
    """The fully-jitted while_loop path must agree with the host loop to
    f64 roundoff."""
    from ecw_cc_tpu.ops.ccs import Gccs
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCS

    ecw = ecw_h2o
    VX = Exp(0.5, ecw.exp_data, ecw.mol, ecw.mo_coeff, Ek_exp_GS=ecw.Ek_exp_GS)
    solver = Solver_CCS(Gccs(ecw.eris), VX, conv="tl", conv_thres=1e-5,
                        diis="", maxiter=80)
    r_host = solver._scf_host(0.5)
    r_dev = solver.SCF_device(0.5)
    assert r_host[0] == r_dev[0]
    assert np.max(np.abs(r_host[5][0] - r_dev[5][0])) < 1e-12
    assert np.max(np.abs(r_host[5][1] - r_dev[5][1])) < 1e-12
    assert np.allclose(r_host[1], r_dev[1], atol=1e-10)


def test_ccsd_L0_equals_plain_ccsd(ecw_h2o):
    """The key regression invariant: at L=0, ECW-CCSD == vanilla CCSD
    (reference Solver_GS.py:885, required parity 1e-8)."""
    ecw = ecw_h2o
    res = ecw.CCSD_GS([0.0], conv_thres=1e-8, maxiter=60)
    Ep0 = res[1][-1]
    eris = ecw.eris
    nocc, nvir = ecw.nocc, ecw.nvir
    e = np.diag(ecw.fock)
    eia = e[:nocc, None] - e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t1 = jnp.zeros((nocc, nvir))
    t2 = jnp.asarray(np.asarray(eris.oovv) / eijab)
    e_old = 0.0
    for _ in range(120):
        t1, t2 = ccsd_ops.tupdate(eris, t1, t2, None)
        e_cc = float(ccsd_ops.energy(eris, t1, t2, None))
        if abs(e_cc - e_old) < 1e-12:
            break
        e_old = e_cc
    assert abs(e_cc - Ep0) < 1e-8
    # literature check: H2O/6-31G CCSD correlation energy ~ -0.1354
    assert abs(e_cc - (-0.13540)) < 2e-4


def test_lambda_sweep_warm_start(ecw_h2o):
    """Sweep over several L values with warm-started amplitudes
    (reference Main.py:595-646)."""
    ecw = ecw_h2o
    Larray = np.linspace(0.0, 0.4, 3)
    res = ecw.CCS_GS(Larray, conv_thres=1e-5, maxiter=80)
    assert len(ecw.Ep_lamb) == 3
    assert len(ecw.Delta_lamb) == 3
    # Delta decreases as the constraint is turned on
    assert ecw.Delta_lamb[-1] < ecw.Delta_lamb[0]


def test_ccsd_diis(ecw_h2o):
    """CCSD with joint tl-DIIS converges and matches the no-DIIS fixed point."""
    ecw = ecw_h2o
    r1 = ecw.CCSD_GS([0.1], conv_thres=1e-7, maxiter=60)
    r2 = ecw.CCSD_GS([0.1], conv_thres=1e-7, maxiter=60, diis="tl")
    assert abs(r1[1][-1] - r2[1][-1]) < 1e-6


def test_l1_regularization_sparsifies():
    """L1 regularization on CCS amplitudes produces sparser solutions
    (reference: Ivanov et al., utilities.subdiff path)."""
    ecw = ECW("h2o", "6-31g")
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    res_plain = ecw.CCS_GS([0.2], conv_thres=1e-6, maxiter=120)
    n_plain = np.sum(np.abs(res_plain[5][0]) > 1e-10)
    res_l1 = ecw.CCS_GS([0.2], alpha=0.02, conv_thres=1e-6, maxiter=120)
    n_l1 = np.sum(np.abs(res_l1[5][0]) > 1e-10)
    assert n_l1 < n_plain


def test_gs_outputs(tmp_path):
    """Cube + table output files are produced (reference Main.py:206-213,
    611-615, 1007-1010)."""
    ecw = ECW("h2", "sto-3g", out_dir=str(tmp_path))
    ecw.Build_GS_exp("mat", "HF", field=[0.02, 0.0, 0.0])
    ecw.CCS_GS([0.1], nbr_cube_file=1, maxiter=50)
    files = {f.name for f in tmp_path.iterdir()}
    assert "HF.cube" in files
    assert "target_GS.cube" in files
    assert "output.txt" in files
    assert any(f.startswith("L0.10") for f in files)


def test_checkpoint_resume(tmp_path):
    """Lambda-sweep checkpointing: amplitudes serialized per lambda and
    reusable as warm starts across driver instances."""
    ecw = ECW("h2", "sto-3g")
    ecw.Build_GS_exp("mat", "HF", field=[0.02, 0.0, 0.0])
    ck = str(tmp_path / "ckpt")
    ecw.CCSD_GS([0.0, 0.1], conv_thres=1e-7, maxiter=50, checkpoint_dir=ck)
    from ecw_cc_tpu.utils import checkpoint
    L, amps = checkpoint.last_checkpoint(ck)
    assert L == 0.1
    assert set(amps) == {"ts", "ls", "td", "ld"}
    # resume: a fresh driver run warm-starts from the saved amplitudes
    ecw2 = ECW("h2", "sto-3g")
    ecw2.Build_GS_exp("mat", "HF", field=[0.02, 0.0, 0.0])
    res = ecw2.CCSD_GS([0.1], conv_thres=1e-7, maxiter=50,
                       checkpoint_dir=ck, resume=True)
    assert "Convergence reached" in res[0]
    assert len(res[1]) <= 4  # warm start converges almost immediately


def test_mixed_precision_polish(ecw_h2o):
    """f32 solve + a few f64 polish iterations reaches the f64 fixed point
    to 1e-8 (BASELINE.md mixed-precision scheme)."""
    import jax
    import jax.numpy as jnp
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD, polish_f64

    ecw = ecw_h2o
    L = 0.1
    # full f64 solve (ground truth)
    VX64 = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    s64 = Solver_CCSD(GCC(ecw.eris), VX64, conv="tl", conv_thres=1e-10,
                      maxiter=120)
    r64 = s64.SCF(L)
    # f32 solve
    eris32 = ecw.eris_host.to_device(dtype="float32")
    VX32 = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    s32 = Solver_CCSD(GCC(eris32), VX32, conv="tl", conv_thres=3e-6,
                      maxiter=120)
    r32 = s32.SCF(L)
    e32 = r32[1][-1]
    assert abs(e32 - r64[1][-1]) > 1e-9  # f32 alone is NOT at 1e-8
    # polish
    VXp = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    amps, Ep, rdm1_64 = polish_f64(ecw.eris_host, VXp, L, r32[5], n_iter=8)
    assert rdm1_64.dtype == np.float64
    assert abs(Ep - r64[1][-1]) < 1e-8
    for a, b in zip(amps, r64[5]):
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))) < 1e-6


def test_l1_grad_solver():
    """Ivanov-style L1 proximal-gradient solver runs and sparsifies
    (reference Solver_GS.L1_grad :375-514)."""
    ecw = ECW("h2", "6-31g")
    ecw.Build_GS_exp("mat", "HF", field=[0.03, 0.0, 0.0])
    res = ecw.CCS_GS([0.1], method="L1_grad", alpha=0.001, beta=0.5,
                     conv_thres=1e-7, maxiter=300)
    assert len(res[1]) > 1
    ts = res[5][0]
    assert np.all(np.isfinite(ts))


def test_printNO_molden(tmp_path, ecw_h2o):
    """Natural-orbital molden output (reference utilities.printNO)."""
    from ecw_cc_tpu.utils import output

    ecw = ecw_h2o
    res = ecw.CCS_GS([0.1], conv_thres=1e-6, maxiter=60)
    f = output.printNO(res[4], ecw.mf, ecw.mol, str(tmp_path / "no"))
    text = open(f).read()
    assert "[Molden Format]" in text
    assert "Occup=" in text


def test_diff_cube(tmp_path):
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.utils import output
    from ecw_cc_tpu.models.scf import RHF

    mol = Molecule("h2", "sto-3g")
    mf = RHF(mol)
    mf.kernel()
    dm = mf.make_rdm1()
    f1 = output.cube_density(mol, str(tmp_path / "a"), dm, nx=12, ny=12, nz=12)
    f2 = output.cube_density(mol, str(tmp_path / "b"), 0.5 * dm, nx=12, ny=12, nz=12)
    fd = output.diff_cube(f1, f2, str(tmp_path / "d"))
    # difference of densities = half the original density at every point
    la = open(f1).readlines()
    ld = open(fd).readlines()
    va = np.array([float(x) for x in "".join(la[8:]).split()])
    vd = np.array([float(x) for x in "".join(ld[8:]).split()])
    assert np.allclose(vd, 0.5 * va, atol=1e-10)


def test_ccsd_l1_alpha_scan(ecw_h2o):
    """BASELINE config 3: L1-regularized ECW-CCSD (SLEP prox) — alpha=0
    degenerates to the plain update, larger alpha sparsifies t2."""
    ecw = ecw_h2o
    # alpha=None and alpha=0 agree at L=0 (the reference's own anchor,
    # Solver_GS.py:851-855).  At L>0 they differ slightly BY DESIGN of the
    # reference: setting alpha switches lupdate to the E=0 branch
    # (CCSD.py:449-456), changing lambda and hence the Vexp feedback.
    r_plain = ecw.CCSD_GS([0.0], conv_thres=1e-8, maxiter=120)
    r_a0 = ecw.CCSD_GS([0.0], alpha=0.0, conv_thres=1e-8, maxiter=120)
    assert abs(r_plain[1][-1] - r_a0[1][-1]) < 1e-7
    nz = []
    for alpha in (0.0, 0.01):
        r = ecw.CCSD_GS([0.05], alpha=alpha, conv_thres=1e-7, maxiter=80)
        nz.append(int(np.sum(np.abs(r[5][2]) > 1e-10)))  # t2 sparsity
    assert nz[1] < nz[0]


def test_solver_populates_iteration_metrics(h2o_631g, tmp_path):
    """Every solve must leave structured metrics on the solver
    (utils/metrics.py wired into the product) and honor the
    ECW_CC_TPU_METRICS JSONL sink."""
    import json
    import os
    from ecw_cc_tpu.ops.ccs import Gccs
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCS

    mol, ghf, eris_host, eris = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    mycc = Gccs(eris)
    exp = Exp(0.1, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
    solver = Solver_CCS(mycc, exp, conv="tl", conv_thres=1e-6, maxiter=50)
    sink = tmp_path / "metrics.jsonl"
    os.environ["ECW_CC_TPU_METRICS"] = str(sink)
    try:
        text, Ep_it, Delta_it, conv_it, rdm1, amps = solver.SCF(0.1)
    finally:
        del os.environ["ECW_CC_TPU_METRICS"]
    m = solver.last_metrics
    assert m.rows, "no metrics recorded"
    assert len(m.rows) == len(Ep_it)
    assert m.rows[-1]["Ep"] == float(Ep_it[-1])
    assert "Delta" in m.rows[0] and "vmax" in m.rows[0]
    assert m.table()  # renders
    lines = [json.loads(l) for l in sink.read_text().splitlines() if l.strip()]
    assert len(lines) == len(Ep_it)
    assert lines[0]["solver"] == "CCS_device"


def test_ccsd_solve_sector_path_matches_dense(h2o_631g):
    """Full SCF_device solve with the spin-sector ladder force-enabled equals
    the dense solve (the size gate normally keeps small systems dense)."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve():
        mycc = GCC(eris)
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        s = Solver_CCSD(mycc, exp, conv="tl", conv_thres=1e-9, diis="tl",
                        maxiter=60)
        return s.SCF_device(0.05)

    old_mode = cfg.get_config().ladder_mode
    try:
        cfg.set_config(ladder_mode="sectors")
        out_s = solve()
        cfg.set_config(ladder_mode="packed")
        out_p = solve()
    finally:
        cfg.set_config(ladder_mode=old_mode)
    out_d = solve()
    assert "Convergence reached" in out_p[0]
    assert len(out_p[1]) == len(out_d[1])
    assert abs(out_p[1][-1] - out_d[1][-1]) < 1e-10
    assert "Convergence reached" in out_s[0]
    assert len(out_s[1]) == len(out_d[1])          # same iteration count
    assert abs(out_s[1][-1] - out_d[1][-1]) < 1e-10
    for a, b in zip(out_s[5], out_d[5]):
        assert np.allclose(a, b, atol=1e-8)


def test_scf_device_refine_recovers_f64_parity(h2o_631g):
    """SCF_device(refine=True): an f32 device solve + 6 f64 polish
    iterations must match the full-f64 solve to 1e-8 (mixed-precision
    scheme)."""
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris64 = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def make(er, host=None):
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        return Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-7,
                           diis="tl", maxiter=60, eris_host=host)

    # full f64 reference solve
    out64 = make(eris64).SCF_device(0.05)
    # f32 solve + f64 polish
    eris32 = eris_host.to_device(dtype="float32")
    out32 = make(eris32, host=eris_host).SCF_device(0.05, refine=True)
    assert abs(out32[1][-1] - out64[1][-1]) < 1e-8
    for a, b in zip(out32[5], out64[5]):
        assert a.dtype == np.float64
        assert np.max(np.abs(a - b)) < 1e-7
    # without refine the f32 solve is NOT at f64 parity (sanity of the test)
    out32_raw = make(eris32, host=eris_host).SCF_device(0.05)
    assert abs(out32_raw[1][-1] - out64[1][-1]) > 1e-8


def test_pack_on_build_matches_dense(h2o_631g):
    """build_eris_device(pack_ladder=True) produces exactly the same packed
    ladder operand as packing the dense block (transposed orientation —
    pack_vvvv yields wc[E,A], the slab build wc[A,E]; both contract
    identically by pair-swap symmetry), never materializing dense vvvv;
    a full SCF_device solve with the threaded op matches the dense solve."""
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops import ladder
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris = h2o_631g
    dense = build_eris_device(mol, ghf, dtype="float64")
    er_p, packed = build_eris_device(mol, ghf, dtype="float64",
                                     pack_ladder=True)
    assert er_p.vvvv.size == 0 and er_p.nvir == dense.nvir
    ref = ladder.pack_vvvv(dense.vvvv)
    assert np.array_equal(np.asarray(packed.wc), np.asarray(ref.wc).T)

    t2 = np.asarray(dense.oovv)
    y_packed = np.asarray(ladder.packed_vvvv_contract(packed, dense.oovv))
    y_dense = 0.5 * np.einsum("ijef,abef->ijab", t2, np.asarray(dense.vvvv))
    assert np.max(np.abs(y_packed - y_dense)) < 1e-11

    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve(er, op):
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        s = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-9, diis="tl",
                        maxiter=60, vvvv_op=op)
        return s.SCF_device(0.05)

    out_p = solve(er_p, packed)
    out_d = solve(dense, None)
    assert "Convergence reached" in out_p[0]
    assert abs(out_p[1][-1] - out_d[1][-1]) < 1e-10
    for a, b in zip(out_p[5], out_d[5]):
        assert np.allclose(a, b, atol=1e-8)

    # guard: deriving an op from the placeholder must fail loudly
    import pytest as _pytest
    with _pytest.raises(ValueError, match="not materialized"):
        ladder.make_vvvv_op(er_p.vvvv)


def test_scf_device_hybrid_precision_schedule(h2o_631g):
    """iter_precision='hybrid' (bf16 leg until hybrid_switch, then 'highest'
    to conv_thres) lands on the same fixed point as the plain 'highest'
    solve — on CPU the matmul-precision stamps are numerical no-ops, so
    this pins the two-while_loop control flow (phase handoff, shared
    iteration/history counters, status codes)."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve():
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        s = Solver_CCSD(GCC(eris), exp, conv="tl", conv_thres=1e-9,
                        diis="tl", maxiter=60)
        return s.SCF_device(0.05)

    old = cfg.get_config().iter_precision
    old_fast = cfg.get_config().hybrid_fast
    try:
        cfg.set_config(iter_precision="hybrid")
        out_h = solve()
        # bf16 fast leg: on CPU bf16 storage ROUNDS for real (matmul
        # precision stamps are CPU no-ops, storage casts are not), so this
        # exercises a genuinely reduced-precision leg handing off to the
        # exact fixed point
        cfg.set_config(hybrid_fast="bf16")
        out_b = solve()
    finally:
        cfg.set_config(iter_precision=old, hybrid_fast=old_fast)
    out_ref = solve()
    assert "Convergence reached" in out_h[0]
    assert abs(out_h[1][-1] - out_ref[1][-1]) < 1e-10
    for a, b in zip(out_h[5], out_ref[5]):
        assert np.allclose(a, b, atol=1e-8)
    assert "Convergence reached" in out_b[0]
    assert abs(out_b[1][-1] - out_ref[1][-1]) < 1e-9
    for a, b in zip(out_b[5], out_ref[5]):
        assert np.allclose(a, b, atol=1e-7)


def test_ccsd_gs_refine_through_driver():
    """ECW.CCSD_GS(refine=True) in f32 production mode returns f64-parity
    energies (the driver-level mixed-precision path: f32 device solve +
    f64 polish per lambda)."""
    from ecw_cc_tpu import config as cfg

    old_dtype = cfg.get_config().dtype

    def run(dtype, refine):
        cfg.set_config(dtype=dtype)
        ecw = ECW("h2o", "6-31g")
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        return ecw.CCSD_GS([0.1], conv_thres=1e-7, maxiter=60, diis="tl",
                           refine=refine)

    try:
        r64 = run("float64", False)
        r32 = run("float32", True)
        r32_raw = run("float32", False)
    finally:
        cfg.set_config(dtype=old_dtype)
    assert abs(r32[1][-1] - r64[1][-1]) < 1e-8
    assert r32[5][0].dtype == np.float64
    # sanity: without refine the f32 sweep is NOT at f64 parity
    assert abs(r32_raw[1][-1] - r64[1][-1]) > 1e-8


def test_solver_cache_respects_precision_change(h2o_631g):
    """Changing iter_precision between SCF_device calls on the SAME solver
    must build a new program (the cache key includes the precision fields;
    a stale cached program silently ignoring the config was a review
    finding)."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
    solver = Solver_CCSD(GCC(eris), exp, conv="tl", conv_thres=1e-8,
                         diis="tl", maxiter=60)
    old = cfg.get_config().iter_precision
    try:
        out1 = solver.SCF_device(0.05)
        cfg.set_config(iter_precision="hybrid")
        out2 = solver.SCF_device(0.05)
    finally:
        cfg.set_config(iter_precision=old)
    assert len(solver._device_solvers) == 2
    assert abs(out1[1][-1] - out2[1][-1]) < 1e-9


def test_ccsd_gs_parallel_mode(h2o_631g):
    """ECW.CCSD_GS(mode='parallel') runs the batched-lambda solver through
    the driver and lands on the same converged energies as the sequential
    sweep at each lambda."""
    from ecw_cc_tpu import ECW

    def run(mode):
        ecw = ECW("h2o", "6-31g")
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        ecw.CCSD_GS(np.linspace(0.0, 0.1, 3), conv_thres=1e-8, maxiter=60,
                    diis="tl", mode=mode)
        return np.asarray(ecw.Ep_lamb)

    ep_par = run("parallel")
    ep_seq = run("sweep")
    assert np.allclose(ep_par, ep_seq, atol=1e-9)


def test_F_target_device_solver_matches_host(h2o_sto3g):
    """Structure-factor ('F') constrained GS solve on the DEVICE while_loop
    path: make_gs_vexp_device supports 'F' and
    SCF_device matches the host-orchestrated loop to 1e-8.  (Reference
    exp_pot.py:324-341 — its R/G shape bug fixed on both paths here.)"""
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.solvers.gs import Solver_CCSD
    from ecw_cc_tpu.utils import props

    mol, ghf, eris_host, eris_dev = h2o_sto3g
    rdm1_ao = ghf.make_rdm1()
    h = [[1, 1, 1], [0, 1, 1], [1, 0, 1]]
    rec = np.asarray([10.0, 10.0, 10.0])
    F_target = props.structure_factor(mol, h, rdm1_ao, mo_coeff=ghf.mo_coeff,
                                      g=True, aobasis=True, rec_vec=rec)
    F_target = [f * 1.05 for f in F_target]  # off HF so the potential acts
    exp_data = [[["F", F_target, h, rec]]]

    Vh = Exp(0.05, exp_data, mol, ghf.mo_coeff)
    host = Solver_CCSD(GCC(eris_dev), Vh, conv="tl", conv_thres=1e-9,
                       maxiter=60)
    out_h = host._scf_host(0.05)
    assert "Convergence reached" in out_h[0]

    Vd = Exp(0.05, exp_data, mol, ghf.mo_coeff)
    dev = Solver_CCSD(GCC(eris_dev), Vd, conv="tl", conv_thres=1e-9,
                      maxiter=60)
    assert dev._device_ok, "'F' must be device-eligible now"
    out_d = dev.SCF_device(0.05)
    assert "Convergence reached" in out_d[0]
    assert abs(out_h[1][-1] - out_d[1][-1]) < 1e-8          # Ep
    assert np.max(np.abs(out_h[4] - out_d[4])) < 1e-8       # rdm1
    for a, b in zip(out_h[5], out_d[5]):                    # amplitudes
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))) < 1e-7


def test_cli_runner_spec(tmp_path):
    """`python -m ecw_cc_tpu spec.json` (headless experiment runner) drives
    the doctest-anchor experiment end to end from a JSON spec."""
    import json

    from ecw_cc_tpu.__main__ import run_spec

    spec = {
        "molecule": "h2o", "basis": "6-31g",
        "out_dir": str(tmp_path),
        "target": {"prop": "mat", "posthf": "HF",
                   "field": [0.05, 0.01, 0.0]},
        "run": {"solver": "CCS_GS", "Larray": [0.5, 0.5, 1]},
    }
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    # CCS_GS returns the last lambda's Result tuple (text, Ep, ...)
    result = run_spec(json.loads(path.read_text()))
    assert result[0].startswith("Convergence reached")
    # doctest anchor: Ep_total = -75.98424 at L=0.5
    import numpy as np

    # result Ep is the correlation part; doctest anchor:
    # Ep_total = -75.98424 = EHF (-75.98395) + (-2.9451e-4)
    ep = float(np.asarray(result[1]).ravel()[-1])
    assert abs(ep - (-2.9451e-4)) < 2e-6


def test_cube_orbital_g(tmp_path):
    """cube_orbital_g: a single occupied spin-orbital pair integrates to
    its electron count (here: both electrons of H2 in the HOMO)."""
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.models.scf import RHF, GHF
    from ecw_cc_tpu.utils import output

    mol = Molecule("h2", "sto-3g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    nmo = ghf.mo_coeff.shape[1]
    vec = np.zeros(nmo)
    vec[0] = 1.0  # lowest (alpha HOMO) spin orbital
    f = output.cube_orbital_g(vec, ghf.mo_coeff, mol,
                              str(tmp_path / "orb"), nx=24, ny=24, nz=24)
    lines = open(f).readlines()
    n = int(lines[2].split()[0])
    vals = np.array([float(x) for x in "".join(lines[6 + n:]).split()])
    # grid-integrate |phi|^2: one normalized orbital -> ~1 electron
    dx = float(lines[3].split()[1])
    dy = float(lines[4].split()[2])
    dz = float(lines[5].split()[3])
    assert abs(vals.sum() * dx * dy * dz - 1.0) < 0.05


def test_driver_custom_geometry_second_row():
    """The driver accepts arbitrary geometry strings and non-catalog
    elements, like the reference's Main.py input path (Main.py:131-143
    accepts any geometry + basis): H2S (second row, r4 front-end
    extension) runs Build_GS_exp -> CCS_GS end to end."""
    ecw = ECW("S 0 0 0.103; H 0 0.962 -0.824; H 0 -0.962 -0.824", "sto-3g")
    ecw.Build_GS_exp("mat", "HF", field=[0.02, 0.0, 0.0])
    res = ecw.CCS_GS([0.1], conv_thres=1e-6, maxiter=80)
    assert "onverg" in res[0]
    assert np.isfinite(res[1][-1])
    assert abs(np.trace(np.asarray(res[4])) - ecw.nocc) < 1e-8
