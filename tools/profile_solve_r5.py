"""Segment the converging-solve overhead over the fixed-chain step: the
pVTZ solve costs more per iteration than the fixed-length chain step; the
difference sits in DIIS + convergence bookkeeping.

Segments measured on the default device (all chained >= 40 iterations to
amortize the per-dispatch cost):
  1. step chain, diis=''      (the bench value_ms program)
  2. step chain, diis='tl'    (identical program + packed DIIS each iter)
  3. diis_update microbench at the packed pVTZ vector size
  4. ring-ops-only microbench (same minus the bordered 17x17 solve)
  5. pack/unpack roundtrip microbench (4x ov + 4x oovv per iteration)

Usage: python tools/profile_solve_r5.py [pvdz|pvtz|both]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench as B


def chain(basis, diis, n_iters=40):
    import jax.numpy as jnp
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops.ladder import resolve_mode, spin_sort_perm
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD
    from ecw_cc_tpu.ops.ccsd import GCC

    mol, ghf = B.build_host(basis)
    nocc = int(np.sum(np.asarray(ghf.mo_occ) > 0))
    nvir = 2 * mol.nao - nocc
    sort = resolve_mode(nvir) == "packed"
    if sort:
        eris, vvvv_op = build_eris_device(mol, ghf, dtype="float32",
                                          pack_ladder=True, sort_spin=True)
        perm = spin_sort_perm(ghf.orbspin, nocc)
    else:
        eris = build_eris_device(mol, ghf, dtype="float32")
        vvvv_op, perm = None, None
    target_np = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    exp = Exp(B.LW, [[["mat", target_np]]], mol=mol, mo_coeff=ghf.mo_coeff)
    solver = Solver_CCSD(GCC(eris), exp, conv="tl", conv_thres=0.0,
                         diis=diis, maxiter=n_iters, vvvv_op=vvvv_op,
                         mo_perm=perm)
    # raw device program + SCALAR fetch only (SCF_device would round-trip
    # every amplitude tensor to the host, ~3 s at pVTZ — bench.py pattern)
    run = solver._build_device_solver(diis, False)
    Lw = jnp.asarray(solver.myVexp.L_check(B.LW)[0], jnp.float32)
    alpha_v = jnp.asarray(0.0, jnp.float32)
    args = (solver.tsini, solver.lsini, solver.tdini, solver.ldini)
    vvsect = solver._get_vvvv_op()
    out = run(eris, vvsect, Lw, *args, alpha_v)    # compile + run
    k = int(out[6])
    assert k >= n_iters
    float(np.asarray(out[8])[k - 1])
    import jax

    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = run(eris, vvsect, Lw, *args, alpha_v)
        k_h, ep_h = jax.device_get((out[6], out[8]))   # one transfer
        float(ep_h[int(k_h) - 1])
        best = min(best, (time.perf_counter() - t0) / n_iters * 1e3)
    return best


def micro_diis(n_vec, n_iters=200, space=15, ring_only=False):
    """Chained diis_update at vector size n_vec inside one jitted
    fori_loop; ring_only replaces the bordered solve with a one-hot
    coefficient read (same memory traffic, no 17x17 linalg.solve)."""
    import jax
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import diis as diis_ops

    @jax.jit
    def run(x0):
        st = diis_ops.diis_init(n_vec, space, dtype=x0.dtype)

        def body(i, carry):
            st, x = carry
            if ring_only:
                err = x - st.last
                xs = st.xs.at[st.head].set(x)
                errs = st.errs.at[st.head].set(err)
                g = errs @ err
                Bm = st.B.at[st.head, :].set(g).at[:, st.head].set(g)
                c = jnp.zeros((space,), x.dtype).at[st.head].set(1.0)
                x_new = c @ xs
                st = diis_ops.DIISState(
                    xs=xs, errs=errs, last=x_new, B=Bm,
                    nvec=jnp.minimum(st.nvec + 1, space),
                    head=(st.head + 1) % space,
                    has_last=jnp.ones((), bool))
            else:
                st, x_new = diis_ops.diis_update(st, x, 2)
            # keep the chain data-dependent
            return st, x_new * (1.0 - 1e-7) + 1e-9 * i
        st, x = jax.lax.fori_loop(0, n_iters, body, (st, x0))
        return jnp.sum(x)

    x0 = jnp.asarray(np.random.default_rng(0).standard_normal(n_vec),
                     jnp.float32)
    float(run(x0))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        float(run(x0))
        best = min(best, (time.perf_counter() - t0) / n_iters * 1e3)
    return best


def micro_pack(basis, n_iters=200):
    """4x pack + 4x unpack of ov/oovv per iteration (what diis='tl' adds
    around the update) in one chained jit."""
    import jax
    import jax.numpy as jnp
    from ecw_cc_tpu.ops import spinsect as ss

    mol, ghf = B.build_host(basis)
    nocc = int(np.sum(np.asarray(ghf.mo_occ) > 0))
    nvir = 2 * mol.nao - nocc
    oa = nocc // 2
    info = ss.SectorInfo(oa, nocc - oa, nvir // 2, nvir - nvir // 2)
    sym = True

    @jax.jit
    def run(a2, a4):
        def body(i, c):
            a2, a4 = c
            f2 = ss.pack_balanced(a2, "ov", info, sym=sym)
            f4 = ss.pack_balanced(a4, "oovv", info, sym=sym)
            b2 = ss.unpack_balanced(f2, "ov", info, sym=sym)
            b4 = ss.unpack_balanced(f4, "oovv", info, sym=sym)
            return b2 * (1 - 1e-7), b4 * (1 - 1e-7)
        a2, a4 = jax.lax.fori_loop(0, n_iters, body, (a2, a4))
        return jnp.sum(a2) + jnp.sum(a4)

    rng = np.random.default_rng(0)
    a2 = jnp.asarray(rng.standard_normal((nocc, nvir)), jnp.float32)
    a4 = jnp.asarray(rng.standard_normal((nocc, nocc, nvir, nvir)),
                     jnp.float32)
    float(run(a2, a4))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        float(run(a2, a4))
        best = min(best, (time.perf_counter() - t0) / n_iters * 1e3)
    return best


def main(which):
    import ecw_cc_tpu.config as config

    config.set_config(x64=False, dtype="float32")
    config.setup_jax()
    from ecw_cc_tpu.ops import spinsect as ss

    for basis in (["cc-pvdz", "cc-pvtz"] if which == "both" else [which]):
        mol, ghf = B.build_host(basis)
        nocc = int(np.sum(np.asarray(ghf.mo_occ) > 0))
        nvir = 2 * mol.nao - nocc
        oa = nocc // 2
        info = ss.SectorInfo(oa, nocc - oa, nvir // 2, nvir - nvir // 2)
        n_ov = ss.packed_size("ov", info, sym=True)
        n_4 = ss.packed_size("oovv", info, sym=True)
        nvec = 2 * n_ov + 2 * n_4
        print(f"== {basis} (nocc={nocc} nvir={nvir}, packed nvec={nvec}) ==",
              flush=True)
        t_plain = chain(basis, "")
        print(f"  step chain diis='':   {t_plain:8.3f} ms/iter", flush=True)
        t_diis = chain(basis, "tl")
        print(f"  step chain diis='tl': {t_diis:8.3f} ms/iter "
              f"(delta {t_diis - t_plain:+.3f})", flush=True)
        t_full = micro_diis(nvec)
        print(f"  diis_update micro:    {t_full:8.3f} ms/iter", flush=True)
        t_ring = micro_diis(nvec, ring_only=True)
        print(f"  ring-ops-only micro:  {t_ring:8.3f} ms/iter "
              f"(bordered solve {t_full - t_ring:+.3f})", flush=True)
        t_pack = micro_pack(basis)
        print(f"  pack/unpack micro:    {t_pack:8.3f} ms/iter", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "both")
