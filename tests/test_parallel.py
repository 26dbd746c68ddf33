"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest


def test_mesh_construction():
    from ecw_cc_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_dp=2)
    assert mesh.axis_names == ("dp", "tp")
    assert mesh.devices.shape == (2, 4)


def test_sharded_ccsd_step_matches_replicated():
    """The fully sharded ECW-CCSD step must produce identical numbers to the
    single-device step (XLA inserts collectives; math must not change)."""
    import __graft_entry__ as g
    from ecw_cc_tpu.parallel.mesh import make_mesh
    from ecw_cc_tpu.parallel.sharding import shard_eris, amp_shardings

    dtype = jnp.float64
    nocc, nvir = 4, 8
    eris = g._synthetic_eris(nocc, nvir, dtype)
    nmo = nocc + nvir
    target = jnp.eye(nmo, dtype=dtype) * (jnp.arange(nmo) < nocc)
    step = g._step_fn(eris, target, jnp.asarray(0.1, dtype))

    rng = np.random.default_rng(1)
    t1 = jnp.asarray(rng.standard_normal((nocc, nvir)) * 0.01, dtype)
    t2 = jnp.asarray(rng.standard_normal((nocc, nocc, nvir, nvir)) * 0.01, dtype)
    t2 = t2 - jnp.transpose(t2, (1, 0, 2, 3))
    t2 = t2 - jnp.transpose(t2, (0, 1, 3, 2))
    l1, l2 = t1 * 0.5, t2 * 0.5
    ref = jax.jit(step)(t1, t2, l1, l2)

    mesh = make_mesh(n_dp=2)
    eris_sh = shard_eris(eris, mesh)
    sh = amp_shardings(mesh)
    step_sh = g._step_fn(eris_sh, target, jnp.asarray(0.1, dtype))
    out = jax.jit(step_sh)(
        jax.device_put(t1, sh["t1"]), jax.device_put(t2, sh["t2"]),
        jax.device_put(l1, sh["l1"]), jax.device_put(l2, sh["l2"]))
    for a, b in zip(ref, out):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-11)


def test_sharded_full_solve_matches_replicated(h2o_631g):
    """The PRODUCTION while_loop solver (Solver_CCSD.SCF_device with
    on-device DIIS) run with vvvv/ovvv/t2/l2 sharded over the 8-device mesh
    must converge to the same amplitudes/energies as the replicated solve
    (shard the product, not the toy)."""
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD
    from ecw_cc_tpu.parallel.mesh import make_mesh
    from ecw_cc_tpu.parallel.sharding import shard_eris, amp_shardings

    mol, ghf, eris_host, eris = h2o_631g
    nmo = eris.fock.shape[0]
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve(er, sharded):
        mycc = GCC(er)
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        solver = Solver_CCSD(mycc, exp, conv="tl", conv_thres=1e-8,
                             diis="tl", maxiter=60)
        kwargs = {}
        if sharded:
            mesh = make_mesh(n_dp=2)
            sh = amp_shardings(mesh)
            kwargs = dict(ts=jax.device_put(solver.tsini, sh["t1"]),
                          ls=jax.device_put(solver.lsini, sh["l1"]),
                          td=jax.device_put(solver.tdini, sh["t2"]),
                          ld=jax.device_put(solver.ldini, sh["l2"]))
        return solver.SCF_device(0.05, **kwargs)

    text_r, Ep_r, _, _, rdm1_r, amps_r = solve(eris, sharded=False)
    mesh = make_mesh(n_dp=2)
    text_s, Ep_s, _, _, rdm1_s, amps_s = solve(shard_eris(eris, mesh),
                                               sharded=True)
    assert "Convergence reached" in text_r
    assert len(Ep_r) == len(Ep_s)
    assert abs(Ep_r[-1] - Ep_s[-1]) < 1e-10
    assert np.allclose(rdm1_r, rdm1_s, atol=1e-9)
    for a, b in zip(amps_r, amps_s):
        assert np.allclose(a, b, atol=1e-9)


def test_sharded_packed_ladder_solve_matches_replicated(h2o_631g):
    """Production solve on pack-on-build ERIs (dense vvvv never
    materialized) with the PackedVVVV operand sharded over 'tp' — the
    multi-chip route for large bases — equals the replicated packed solve."""
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD
    from ecw_cc_tpu.parallel.mesh import make_mesh
    from ecw_cc_tpu.parallel.sharding import (amp_shardings, shard_eris,
                                              shard_vvvv_op)

    mol, ghf, eris_host, _ = h2o_631g
    er_p, packed = build_eris_device(mol, ghf, dtype="float64",
                                     pack_ladder=True)
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve(er, op, sharded):
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        solver = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8,
                             diis="tl", maxiter=60, vvvv_op=op)
        kwargs = {}
        if sharded:
            mesh = make_mesh(n_dp=2)
            sh = amp_shardings(mesh)
            kwargs = dict(ts=jax.device_put(solver.tsini, sh["t1"]),
                          ls=jax.device_put(solver.lsini, sh["l1"]),
                          td=jax.device_put(solver.tdini, sh["t2"]),
                          ld=jax.device_put(solver.ldini, sh["l2"]))
        return solver.SCF_device(0.05, **kwargs)

    text_r, Ep_r, _, _, rdm1_r, amps_r = solve(er_p, packed, sharded=False)
    mesh = make_mesh(n_dp=2)
    text_s, Ep_s, _, _, rdm1_s, amps_s = solve(
        shard_eris(er_p, mesh), shard_vvvv_op(packed, mesh), sharded=True)
    assert "Convergence reached" in text_r
    assert len(Ep_r) == len(Ep_s)
    assert abs(Ep_r[-1] - Ep_s[-1]) < 1e-10
    assert np.allclose(rdm1_r, rdm1_s, atol=1e-9)
    for a, b in zip(amps_r, amps_s):
        assert np.allclose(a, b, atol=1e-9)


def test_sharded_sectored_ladder_solve_matches_replicated(h2o_631g):
    """Production solve on spin-SORTED pack-on-build ERIs with every
    SectoredVVVV sector row-sharded over 'tp' (the multi-chip route for the
    sorted production layout) equals the replicated sorted solve AND the
    alternating-layout solve in the public convention."""
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops import ladder
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD
    from ecw_cc_tpu.parallel.mesh import make_mesh
    from ecw_cc_tpu.parallel.sharding import (amp_shardings, shard_eris,
                                              shard_vvvv_op)

    mol, ghf, eris_host, _ = h2o_631g
    er_s, sect = build_eris_device(mol, ghf, dtype="float64",
                                   pack_ladder=True, sort_spin=True)
    perm = ladder.spin_sort_perm(ghf.orbspin, er_s.nocc)
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))

    def solve(er, op, sharded):
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        solver = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8,
                             diis="tl", maxiter=60, vvvv_op=op, mo_perm=perm)
        kwargs = {}
        if sharded:
            mesh = make_mesh(n_dp=2)
            sh = amp_shardings(mesh)
            kwargs = dict(ts=jax.device_put(solver.tsini, sh["t1"]),
                          ls=jax.device_put(solver.lsini, sh["l1"]),
                          td=jax.device_put(solver.tdini, sh["t2"]),
                          ld=jax.device_put(solver.ldini, sh["l2"]))
        return solver.SCF_device(0.05, **kwargs)

    text_r, Ep_r, _, _, rdm1_r, amps_r = solve(er_s, sect, sharded=False)
    mesh = make_mesh(n_dp=2)
    sect_sh = shard_vvvv_op(sect, mesh)
    # sector rows padded to the tp multiple (paa=28, pab=64, tp=4)
    assert sect_sh.wc_aa.shape[0] % mesh.shape["tp"] == 0
    text_s, Ep_s, _, _, rdm1_s, amps_s = solve(
        shard_eris(er_s, mesh), sect_sh, sharded=True)
    assert "Convergence reached" in text_r
    assert len(Ep_r) == len(Ep_s)
    assert abs(Ep_r[-1] - Ep_s[-1]) < 1e-10
    assert np.allclose(rdm1_r, rdm1_s, atol=1e-9)
    for a, b in zip(amps_r, amps_s):
        assert np.allclose(a, b, atol=1e-9)


def test_sharded_packed_operand_pads_odd_p():
    """p = nvir(nvir-1)/2 is not divisible by tp for most nvir (13041 at
    cc-pVTZ); shard_vvvv_op must zero-pad the row axis and
    packed_vvvv_contract must slice the padded output back — exercised at
    H2O/STO-3G (p=6, tp=4 -> pad 2)."""
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.models.scf import RHF, GHF
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops import ladder
    from ecw_cc_tpu.parallel.mesh import make_mesh
    from ecw_cc_tpu.parallel.sharding import shard_vvvv_op

    mol = Molecule("h2o", "sto-3g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    dense = build_eris_device(mol, ghf, dtype="float64")
    _, packed = build_eris_device(mol, ghf, dtype="float64",
                                  pack_ladder=True)
    mesh = make_mesh(n_dp=2)
    sh = shard_vvvv_op(packed, mesh)
    p = dense.nvir * (dense.nvir - 1) // 2
    assert sh.wc.shape[0] % mesh.shape["tp"] == 0 and sh.wc.shape[0] > p
    y_sh = np.asarray(ladder.packed_vvvv_contract(sh, dense.oovv))
    y_dense = 0.5 * np.einsum("ijef,abef->ijab", np.asarray(dense.oovv),
                              np.asarray(dense.vvvv))
    assert np.max(np.abs(y_sh - y_dense)) < 1e-12


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)
    # restore f64 config for the rest of the suite
    import ecw_cc_tpu.config as config
    config.set_config(x64=True, dtype="float64")


def test_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(float(out[4]))
    import ecw_cc_tpu.config as config
    config.set_config(x64=True, dtype="float64")


def test_batched_lambda_sweep_matches_sequential(h2o_631g):
    """SCF_batch (vmapped while_loop over the lambda axis, the 'dp' slot of
    the parallelism plan) must converge each lane to the same result as the
    cold-start sequential solves — including lane freezing once a lane
    converges before the others."""
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    Ls = [0.0, 0.05, 0.1]

    def make():
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        return Solver_CCSD(GCC(eris), exp, conv="tl", conv_thres=1e-8,
                           diis="tl", maxiter=60)

    batch = make().SCF_batch(Ls)
    for L, res in zip(Ls, batch):
        seq = make().SCF_device(L)
        assert "Convergence reached" in res[0]
        assert len(res[1]) == len(seq[1]), (L, len(res[1]), len(seq[1]))
        assert abs(res[1][-1] - seq[1][-1]) < 1e-10
        for a, b in zip(res[5], seq[5]):
            assert np.allclose(a, b, atol=1e-9)


def test_batched_hybrid_lane_freeze(h2o_631g):
    """SCF_batch under iter_precision='hybrid': a lane that leaves the fast
    phase first must FREEZE there (not keep taking fast-leg steps on the
    final-thres predicate) while slower lanes finish — every lane must
    still converge to the sequential result."""
    from ecw_cc_tpu import config as cfg
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, eris_host, eris = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    Ls = [0.0, 0.05, 0.1]

    def make():
        exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
        return Solver_CCSD(GCC(eris), exp, conv="tl", conv_thres=1e-8,
                           diis="tl", maxiter=60)

    old = cfg.get_config().iter_precision
    try:
        cfg.set_config(iter_precision="hybrid")
        batch = make().SCF_batch(Ls)
        for L, res in zip(Ls, batch):
            seq = make().SCF_device(L)
            assert "Convergence reached" in res[0], (L, res[0])
            assert abs(res[1][-1] - seq[1][-1]) < 1e-10
            for a, b in zip(res[5], seq[5]):
                assert np.allclose(a, b, atol=1e-8)
    finally:
        cfg.set_config(iter_precision=old)


def test_sharded_packed_ladder_scale_proof():
    """Scale proof at real pVTZ shapes: the packed
    ladder operand sharded over tp=8 really shrinks the per-device vvvv
    footprint to 1/tp, and the compiled sharded contraction contains NO
    all-gather of the big operand (the all-gather-free claim of
    parallel/sharding.py, checked in the HLO rather than asserted in
    prose).  f32 at nvir=162: dense vvvv 2.75 GB -> packed 680 MB total
    -> 85 MB per device at tp=8."""
    import re
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ecw_cc_tpu.ops import ladder
    from ecw_cc_tpu.parallel.mesh import make_mesh
    from ecw_cc_tpu.parallel.sharding import shard_vvvv_op

    nocc, nvir = 14, 162                      # C2H2/cc-pVTZ spin-orbital
    p = nvir * (nvir - 1) // 2                # 13041
    rng = np.random.default_rng(0)
    wc = jnp.asarray(rng.random((p, p), dtype=np.float32) * 1e-3)
    packed = ladder.PackedVVVV(wc=wc)
    mesh = make_mesh(n_dp=1)                  # tp=8
    sh = shard_vvvv_op(packed, mesh)

    # per-device footprint: rows padded to a multiple of tp, then 1/tp each
    tp = mesh.shape["tp"]
    rows = sh.wc.shape[0]
    assert rows == p + (-p) % tp
    shard_shapes = {s.data.shape for s in sh.wc.addressable_shards}
    assert shard_shapes == {(rows // tp, p)}
    per_dev = rows // tp * p * 4
    assert per_dev * tp >= wc.nbytes          # covers the whole operand
    assert per_dev <= wc.nbytes // tp + p * 4 * tp  # ~1/tp each (+pad)

    x = jnp.asarray(
        rng.random((nocc, nocc, nvir, nvir), dtype=np.float32) * 1e-2)
    x = x - jnp.transpose(x, (0, 1, 3, 2))
    x = jax.device_put(x, NamedSharding(mesh, P()))

    # compile-time analysis (numerics of the sharded route are pinned at
    # small sizes by the other tests in this file)
    fn = jax.jit(ladder.packed_vvvv_contract)
    compiled = fn.lower(sh, x).compile()
    hlo = compiled.as_text()
    # the big operand must never be all-gathered: no all-gather touching a
    # pair-axis-sized dimension (13041 or its padded 13048)
    for m in re.finditer(r"all-gather[^\n]*", hlo):
        assert str(p) not in m.group(0) and str(rows) not in m.group(0), \
            m.group(0)


def test_sharded_sectored_t_energy_matches_single(h2o_631g):
    """The (T) pair scan sharded over all 8 mesh devices (operands
    replicated, scalar psum — ops/ccsd_t._sect_scan_t mesh path) equals the
    single-device sectored scan and the dense scan, incl. non-divisible
    pair counts (25 alpha-alpha pairs over 8 devices -> masked padding)."""
    from test_ccsd_kernels import _sorted_system, _mirror_amps
    from ecw_cc_tpu.ops import ccsd_t
    from ecw_cc_tpu.parallel.mesh import make_mesh

    _, _, _, er_dense, _, _, info = _sorted_system(h2o_631g)
    t1, t2, _, _ = map(jnp.asarray, _mirror_amps(info, seed=41))
    mesh = make_mesh(n_dp=2)
    e_dense = float(ccsd_t.energy_t(er_dense, t1, t2))
    for sym in (False, True):
        e_one = float(ccsd_t.energy_t_sect(er_dense, t1, t2, info, sym=sym))
        e_mesh = float(ccsd_t.energy_t_sect(er_dense, t1, t2, info, sym=sym,
                                            mesh=mesh))
        assert abs(e_mesh - e_one) < 1e-12 * max(1.0, abs(e_one))
        assert abs(e_mesh - e_dense) < 1e-11 * max(1.0, abs(e_dense))


def test_sharded_eom_sigma_matches_replicated():
    """EOM-EE sigma (jvp of the residual) on tp-sharded eris/amplitudes
    equals the replicated sigma — GSPMD propagates the shardings through
    the linearized residual, so the EOM Davidson can run multi-chip."""
    import __graft_entry__ as g
    from ecw_cc_tpu.ops import eom
    from ecw_cc_tpu.parallel.mesh import make_mesh
    from ecw_cc_tpu.parallel.sharding import shard_eris, amp_shardings

    dtype = jnp.float64
    nocc, nvir = 4, 8
    eris = g._synthetic_eris(nocc, nvir, dtype)
    rng = np.random.default_rng(3)

    def amps(scale, seed):
        r = np.random.default_rng(seed)
        a1 = jnp.asarray(r.standard_normal((nocc, nvir)) * scale, dtype)
        a2 = jnp.asarray(
            r.standard_normal((nocc, nocc, nvir, nvir)) * scale, dtype)
        a2 = a2 - jnp.transpose(a2, (1, 0, 2, 3))
        a2 = a2 - jnp.transpose(a2, (0, 1, 3, 2))
        return a1, a2

    t1, t2 = amps(0.02, 1)
    r1, r2 = amps(1.0, 2)
    sigma, sigma_left = eom.make_sigma(eris, t1, t2)
    s1_ref, s2_ref = sigma(r1, r2)
    g1_ref, g2_ref = sigma_left(r1, r2)

    mesh = make_mesh(n_dp=2)
    eris_sh = shard_eris(eris, mesh)
    sh = amp_shardings(mesh)
    t1s = jax.device_put(t1, sh["t1"])
    t2s = jax.device_put(t2, sh["t2"])
    r1s = jax.device_put(r1, sh["t1"])
    r2s = jax.device_put(r2, sh["t2"])
    sigma_s, sigma_left_s = eom.make_sigma(eris_sh, t1s, t2s)
    s1, s2 = sigma_s(r1s, r2s)
    g1, g2 = sigma_left_s(r1s, r2s)
    assert np.allclose(np.asarray(s1), np.asarray(s1_ref), atol=1e-11)
    assert np.allclose(np.asarray(s2), np.asarray(s2_ref), atol=1e-11)
    assert np.allclose(np.asarray(g1), np.asarray(g1_ref), atol=1e-11)
    assert np.allclose(np.asarray(g2), np.asarray(g2_ref), atol=1e-11)
