"""Benchmark: FULL ECW-CCSD production iteration on C2H2 (BASELINE.md headline).

Measures the wall-clock of the full production iteration — the body of
Solver_CCSD.SCF_device: rdm1 -> Vexp -> effective Fock -> energy -> T1/T2
update -> Lambda1/Lambda2 update -> convergence norm — by running the REAL
while_loop solver on the default JAX device (the GPU, f32) for a fixed
iteration count and dividing wall time by iterations executed.  Each timed
region ends in a scalar value fetch, so it waits for the device.

Two configs:
  - C2H2/cc-pVDZ (nocc=14, nvir=62 spin orbitals)  — the BASELINE.json config
  - C2H2/cc-pVTZ (nocc=14, nvir=162 spin orbitals) — the vvvv stress config

The baseline is the reference's computational engine: the identical full
iteration in NumPy f64 einsum (the reference is pure NumPy/pyscf-lib.einsum,
SURVEY.md section 0; it publishes no numbers, so the baseline is measured
here, warm-up + best-of-2, and cached keyed on the step definition version
and the host CPU).  The pVTZ NumPy baseline takes minutes per iteration: it
is read from the cache that tools/measure_numpy_baseline.py fills, else
estimated by scaling the measured pVDZ NumPy throughput (FLOP/s) to the
pVTZ FLOP count — flagged as an estimate in the output.

Integrals/SCF run on the host (in-house engine); the MO transform + block
slicing run ON DEVICE via build_eris_device (no cache files).  Effective
TFLOP/s uses the XLA cost analysis of the one-iteration step compiled for
CPU (FLOP count is backend-independent).

Runs on a GPU only: with no GPU it fails at once with a non-zero exit, and a
failure in any row propagates.  Prints ONE JSON line, headline = pVDZ full
iteration:
  {"metric": "ecw_ccsd_full_iteration_c2h2_ccpvdz", "value": <ms>,
   "unit": "ms", "vs_baseline": <numpy_ms/device_ms>, "tflops": <eff>,
   "device": {...}, "pvtz": {...}, "es": {...}, ...}
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HERE = os.path.dirname(os.path.abspath(__file__))
BASE_FILE = os.path.join(HERE, ".bench_baseline.json")
# Bump when the measured step definition changes: the cached NumPy baseline
# is only comparable to the device number for the same step.
STEP_VERSION = 2
LW = 0.01


def _cpu_host_key():
    """8-hex digest of the CPU identity (machine + model + flags).

    The NumPy baseline is a HOST CPU timing (it differed ~2x between two
    development hosts), so cache entries are keyed on the CPU identity; a
    reboot does not change CPU speed, so no boot id.  A baseline measured
    on a different host is still usable but is flagged in the bench JSON."""
    import hashlib
    import platform

    flags = model = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                if ln.startswith("flags") and not flags:
                    flags = " ".join(sorted(ln.split(":", 1)[1].split()))
                elif ln.startswith("model name") and not model:
                    model = ln.split(":", 1)[1].strip()
                if flags and model:
                    break
    except OSError:
        pass
    return hashlib.sha256(
        "|".join((platform.machine(), model, flags)).encode()
    ).hexdigest()[:8]


def _baseline_lookup(cache, basis, allow_foreign=True):
    """(numpy_ms, foreign) from the baseline cache: prefer the entry
    measured on THIS host; optionally fall back to another host's
    measurement (or a legacy un-keyed entry) with foreign=True so the JSON
    can flag it.  allow_foreign=False (the cheap pVDZ baseline) forces a
    re-measure instead of trusting another machine's timing."""
    host_key = f"{basis}_v{STEP_VERSION}_{_cpu_host_key()}"
    if host_key in cache:
        return cache[host_key], False
    if not allow_foreign:
        return None, False
    legacy = cache.get(f"{basis}_v{STEP_VERSION}")
    if legacy is not None:
        return legacy, True
    prefix = f"{basis}_v{STEP_VERSION}_"
    for k, v in sorted(cache.items()):
        if k.startswith(prefix):
            return v, True
    return None, False


# ---------------------------------------------------------------------------
# Reference engine: the identical FULL iteration in NumPy f64 einsum
# ---------------------------------------------------------------------------

def numpy_full_step(blocks, t1, t2, l1, l2, target, Lw):
    """rdm1 -> Vexp('mat') -> fsp -> Ep -> t-update -> lambda-update, all in
    NumPy f64 (np.einsum optimize=True / dgemm for the ladder, i.e. what
    pyscf lib.einsum does for the reference)."""
    e = np.einsum
    opt = dict(optimize=True)
    fock = blocks["fock"]
    oovv, ovvv, ooov = blocks["oovv"], blocks["ovvv"], blocks["ooov"]
    ovov, oooo, vvvv = blocks["ovov"], blocks["oooo"], blocks["vvvv"]
    vovv, ovvo = blocks["vovv"], blocks["ovvo"]
    nocc, nvir = t1.shape
    no2, nv2 = nocc * nocc, nvir * nvir

    # rdm1 (gamma_CCSD)
    doo = -e("ie,je->ij", l1, t1) - 0.5 * e("imef,jmef->ij", l2, t2, **opt)
    dvv = e("ma,mb->ab", t1, l1) + 0.5 * e("mnea,mneb->ab", t2, l2, **opt)
    xt1 = 0.5 * e("mnef,inef->mi", l2, t2, **opt)
    xt2 = 0.5 * e("mnfa,mnfe->ae", t2, l2, **opt) + e("ma,me->ae", t1, l1)
    dvo = (e("imae,me->ai", t2, l1, **opt) - e("mi,ma->ai", xt1, t1)
           - e("ie,ae->ai", t1, xt2) + t1.T)
    dm = np.block([[doo + doo.T, l1 + dvo.T],
                   [(l1 + dvo.T).T, dvv + dvv.T]]) * 0.5
    dm[np.diag_indices(nocc)] += 1.0
    fsp = fock - Lw * (target - dm)

    fov = fsp[:nocc, nocc:]
    diag = np.diag(fock)
    eia = diag[:nocc, None] - diag[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]

    Ep = (e("ia,ia", fov, t1) + 0.25 * e("ijab,ijab", t2, oovv, **opt)
          + 0.5 * e("ia,jb,ijab", t1, t1, oovv, **opt))

    # ---- T update (Stanton factorization, as reference CCSD.py:248-338) ---
    t1t1 = e("ia,jb->ijab", 0.5 * t1, t1)
    t1t1 = t1t1 - t1t1.transpose(1, 0, 2, 3)
    tau = t2 + t1t1 - t1t1.transpose(0, 1, 3, 2)
    t1t1h = 0.5 * t1t1
    tau_t = t2 + t1t1h - t1t1h.transpose(0, 1, 3, 2)

    Fvv = (fsp[nocc:, nocc:] - 0.5 * e("me,ma->ae", fov, t1)
           + e("mf,amef->ae", t1, vovv, **opt)
           - 0.5 * e("mnaf,mnef->ae", tau_t, oovv, **opt))
    Foo = (fsp[:nocc, :nocc] + 0.5 * e("me,ie->mi", fov, t1)
           + e("ne,mnie->mi", t1, ooov, **opt)
           + 0.5 * e("inef,mnef->mi", tau_t, oovv, **opt))
    Fov = fov + e("nf,mnef->me", t1, oovv, **opt)
    tmp = e("je,mnie->mnij", t1, ooov, **opt)
    Woooo = oooo + tmp - tmp.transpose(0, 1, 3, 2) \
        + 0.25 * e("ijef,mnef->mnij", tau, oovv, **opt)
    eris_ovvo = -ovov.transpose(0, 1, 3, 2)
    eris_oovo = -ooov.transpose(0, 1, 3, 2)
    Wovvo = (e("jf,mbef->mbej", t1, ovvv, **opt)
             - e("nb,mnej->mbej", t1, eris_oovo, **opt)
             - 0.5 * e("jnfb,mnef->mbej", t2, oovv, **opt)
             - e("jf,nb,mnef->mbej", t1, t1, oovv, **opt) + eris_ovvo)
    Fvv_d = Fvv - np.diag(diag[nocc:])
    Foo_d = Foo - np.diag(diag[:nocc])

    t1new = (e("ie,ae->ia", t1, Fvv_d) - e("ma,mi->ia", t1, Foo_d)
             + e("imae,me->ia", t2, Fov, **opt)
             - e("nf,naif->ia", t1, ovov, **opt)
             - 0.5 * e("imef,maef->ia", t2, ovvv, **opt)
             - 0.5 * e("mnae,mnie->ia", t2, ooov, **opt) + fov)
    Ftmp = Fvv_d - 0.5 * e("mb,me->be", t1, Fov)
    tmp = e("ijae,be->ijab", t2, Ftmp, **opt)
    t2new = tmp - tmp.transpose(0, 1, 3, 2)
    Ftmp = Foo_d + 0.5 * e("je,me->mj", t1, Fov)
    tmp = e("imab,mj->ijab", t2, Ftmp, **opt)
    t2new -= tmp - tmp.transpose(1, 0, 2, 3)
    t2new += oovv
    t2new += 0.5 * e("mnab,mnij->ijab", tau, Woooo, **opt)
    # vvvv ladder through a dgemm, like pyscf lib.einsum would
    Wv = vvvv.reshape(nv2, nv2)
    tmpb = e("mb,mafe->bafe", t1, ovvv, **opt)
    Wv = Wv - tmpb.reshape(nv2, nv2) + tmpb.transpose(1, 0, 2, 3).reshape(nv2, nv2)
    Wv = Wv + e("mnab,mnef->abef", tau, 0.25 * oovv, **opt).reshape(nv2, nv2)
    t2new += 0.5 * (tau.reshape(no2, nv2) @ Wv.T).reshape(nocc, nocc, nvir, nvir)
    tmp = e("imae,mbej->ijab", t2, Wovvo, **opt)
    tmp += e("ie,ma,mbje->ijab", t1, t1, ovov, **opt)
    tmp = tmp - tmp.transpose(1, 0, 2, 3)
    tmp = tmp - tmp.transpose(0, 1, 3, 2)
    t2new += tmp
    tmp = e("ie,jeba->ijab", t1, ovvv, **opt)
    t2new += tmp - tmp.transpose(1, 0, 2, 3)
    tmp = e("ma,ijmb->ijab", t1, ooov, **opt)
    t2new -= tmp - tmp.transpose(0, 1, 3, 2)
    t1new = t1new / eia
    t2new = t2new / eijab

    # ---- Lambda update (as reference CCSD.py:419-623) ----------------------
    foo_s, fvo = fsp[:nocc, :nocc], fsp[nocc:, :nocc]
    fvv_s = fsp[nocc:, nocc:]
    t1n, t2n = t1new, t2new
    tau_l = t2n + 2.0 * e("ia,jb->ijab", t1n, t1n)
    v1 = (fvv_s - e("ja,jb->ba", fov, t1n)
          - e("jbac,jc->ba", ovvv, t1n, **opt)
          + 0.5 * e("jkca,jkbc->ba", oovv, tau_l, **opt))
    v2 = (foo_s + e("ib,jb->ij", fov, t1n)
          - e("kijb,kb->ij", ooov, t1n, **opt)
          + 0.5 * e("ikbc,jkbc->ij", oovv, tau_l, **opt))
    v3 = e("ijcd,klcd->ijkl", oovv, tau_l, **opt)
    v4 = e("ljdb,klcd->jcbk", oovv, t2n, **opt) + ovvo
    v5 = fvo + e("kc,jkbc->bj", fov, t2n, **opt)
    tmp = fov - e("kldc,ld->kc", oovv, t1n, **opt)
    v5 = v5 + e("kc,kb,jc->bj", tmp, t1n, t1n, **opt)
    v5 = v5 - 0.5 * e("kljc,klbc->bj", ooov, t2n, **opt)
    v5 = v5 + 0.5 * e("kbdc,jkcd->bj", ovvv, t2n, **opt)
    w3 = (v5 + e("jcbk,jb->ck", v4, t1n, **opt)
          + e("cb,jb->cj", v1, t1n) - e("jk,jb->bk", v2, t1n))
    woooo = 0.5 * oooo + 0.25 * v3 + e("jilc,kc->jilk", ooov, t1n, **opt)
    wovvo = (v4 - e("ljdb,lc,kd->jcbk", oovv, t1n, t1n, **opt)
             - e("ljkb,lc->jcbk", ooov, t1n, **opt)
             + e("jcbd,kd->jcbk", ovvv, t1n, **opt))
    wovoo = (0.25 * e("icdb,jkdb->icjk", ovvv, tau_l, **opt)
             + 0.5 * ooov.transpose(2, 3, 0, 1)
             + e("icbk,jb->icjk", v4, t1n, **opt)
             - e("lijb,klcb->icjk", ooov, t2n, **opt))
    wvvvo = (e("jcak,jb->bcak", v4, t1n, **opt)
             + 0.25 * e("jlka,jlbc->bcak", ooov, tau_l, **opt)
             - 0.5 * ovvv.transpose(3, 2, 1, 0)
             + e("kbad,jkcd->bcaj", ovvv, t2n, **opt))
    E = (e("ia,ia", fov, t1n) + 0.25 * e("ijab,ijab", t2n, oovv, **opt)
         + 0.5 * e("ia,jb,ijab", t1n, t1n, oovv, **opt))
    v1d = v1 - np.diag(diag[nocc:])
    v2d = v2 - np.diag(diag[:nocc])

    mba = 0.5 * e("klca,klcb->ba", l2, t2n, **opt)
    mij = 0.5 * e("kicd,kjcd->ij", l2, t2n, **opt)
    m3 = e("klab,ijkl->ijab", l2, woooo, **opt)
    tmp = e("ijcd,klcd->ijkl", l2, tau_l, **opt)
    m3 = m3 + 0.25 * e("klab,ijkl->ijab", oovv, tmp, **opt)
    tmp = e("ijcd,kd->ijck", l2, t1n, **opt)
    m3 = m3 - e("kcba,ijck->ijab", ovvv, tmp, **opt)
    # lambda vvvv ladder as a dgemm
    m3 = m3 + 0.5 * (l2.reshape(no2, nv2) @ vvvv.reshape(nv2, nv2)).reshape(
        nocc, nocc, nvir, nvir)

    l2new = oovv + m3
    fov1 = fov + e("kjcb,kc->jb", oovv, t1n, **opt)
    tmp = e("ia,jb->ijab", l1, fov1)
    tmp = tmp + e("kica,jcbk->ijab", l2, wovvo, **opt)
    tmp = tmp - tmp.transpose(1, 0, 2, 3)
    l2new = l2new + tmp - tmp.transpose(0, 1, 3, 2)
    tmp = e("ka,ijkb->ijab", l1, ooov, **opt)
    tmp = tmp + e("ijca,cb->ijab", l2, v1d, **opt)
    tmp1vv = mba + e("ka,kb->ba", l1, t1n)
    tmp = tmp + e("ca,ijcb->ijab", tmp1vv, oovv, **opt)
    l2new = l2new - (tmp - tmp.transpose(0, 1, 3, 2))
    tmp = e("ic,jcba->jiba", l1, ovvv, **opt)
    tmp = tmp + e("kiab,jk->ijab", l2, v2d, **opt)
    tmp1oo = mij + e("ic,kc->ik", l1, t1n)
    tmp = tmp - e("ik,kjab->ijab", tmp1oo, oovv, **opt)
    l2new = l2new + (tmp - tmp.transpose(1, 0, 2, 3))

    l1new = (fov + e("jb,ibaj->ia", l1, ovvo, **opt)
             + e("ib,ba->ia", l1, v1d)
             - e("ja,ij->ia", l1, v2d)
             - e("kjca,icjk->ia", l2, wovoo, **opt)
             - e("ikbc,bcak->ia", l2, wvvvo, **opt)
             + e("ijab,jb->ia", m3, t1n, **opt)
             + e("jiba,bj->ia", l2, w3, **opt))
    tmp = (t1n + e("kc,kjcb->jb", l1, t2n, **opt)
           - e("bd,jd->jb", tmp1vv, t1n)
           - e("lj,lb->jb", mij, t1n))
    l1new = l1new + e("jiba,jb->ia", oovv, tmp, **opt)
    l1new = l1new + e("icab,bc->ia", ovvv, tmp1vv, **opt)
    l1new = l1new - e("jika,kj->ia", ooov, tmp1oo, **opt)
    tmp = fov - e("kjba,jb->ka", oovv, t1n, **opt)
    l1new = l1new - e("ik,ka->ia", mij, tmp)
    l1new = l1new - e("ca,ic->ia", mba, tmp)
    l1new = l1new - l1new * E
    l2new = l2new - l2new * E
    l1new = l1new / eia
    l2new = l2new / eijab

    return t1new, t2new, l1new, l2new, Ep


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def build_host(basis):
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.models.scf import RHF, GHF

    mol = Molecule("c2h2", basis)
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    return mol, ghf


def device_full_step(target, Lw, sect_info=None, sym=False):
    """The production iteration body (same ops the while_loop solver runs).
    sect_info: SectorInfo when the solver runs the sector-blocked kernels
    (sorted layout); sym: the closed-shell mirror-symmetry mode — the FLOP
    count must reflect the same path, incl. the balanced stacked ladder."""
    from ecw_cc_tpu.ops import ccsd as ccsd_ops
    from ecw_cc_tpu.ops import ladder as ladder_ops

    def step(er, sect, t1, t2, l1, l2):
        if sect_info is not None:
            from ecw_cc_tpu.ops.ccsd_sect import gamma_inter_sect
            rdm1 = ccsd_ops.gamma_CCSD(
                t1, t2, l1, l2,
                inter=gamma_inter_sect(t1, t2, l1, l2, sect_info, sym=sym))
        else:
            rdm1 = ccsd_ops.gamma_CCSD(t1, t2, l1, l2)
        fsp = er.fock - Lw * (target - rdm1)
        Ep = ccsd_ops.energy(er, t1, t2, fsp)
        if sect_info is not None:
            from ecw_cc_tpu.ops.ccsd_sect import (_tau_b, lupdate_sect,
                                                  tupdate_sect)
            from ecw_cc_tpu.ops.spinsect import wrap
            ladder_t = ladder_l = tau_pre = None
            if isinstance(sect, ladder_ops.SectoredVVVV):
                tau_pre = _tau_b(wrap(t2, "oovv", sect_info, sym=sym),
                                 wrap(t1, "ov", sect_info, sym=sym))
                ladder_t, ladder_l = \
                    ladder_ops.balanced_stacked_sectored_contract(
                        sect, tau_pre, l2, sect_info.oa, sym=sym,
                        blocked_info=sect_info)
            t1n, t2n = tupdate_sect(er, t1, t2, fsp, sect_info, vvvv_op=sect,
                                    ladder_pre=ladder_t, sym=sym,
                                    tau_pre=tau_pre)
            l1n, l2n = lupdate_sect(er, t1n, t2n, l1, l2, fsp, sect_info,
                                    vvvv_op=sect, ladder_pre=ladder_l,
                                    sym=sym)
        else:
            t1n, t2n = ccsd_ops.tupdate(er, t1, t2, fsp=fsp, vvvv_op=sect)
            l1n, l2n = ccsd_ops.lupdate(er, t1n, t2n, l1, l2, fsp=fsp,
                                        vvvv_op=sect)
        return t1n, t2n, l1n, l2n, Ep

    return step


def count_flops(step, eris, amps):
    """Backend-independent FLOP count of one full iteration via the XLA cost
    model (compiled for CPU; the contraction set is identical)."""
    import jax

    try:
        lowered = jax.jit(step, backend="cpu").lower(eris, *amps)
        cost = lowered.compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        return float(cost["flops"])
    except Exception as exc:
        print(f"count_flops failed: {exc!r}", file=sys.stderr)
        return float("nan")


def mp2_amps(blocks):
    nocc = blocks["oooo"].shape[0]
    diag = np.diag(blocks["fock"])
    eia = diag[:nocc, None] - diag[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t2 = blocks["oovv"] / eijab
    t1 = np.zeros_like(eia)
    return t1, t2, 0.5 * t1, 0.5 * t2


def bench_config(basis, n_iters, numpy_baseline, measure_high=False,
                 measure_solve=True):
    """Returns dict with value_ms, tflops, (optionally) vs_baseline.

    measure_high: additionally time the solver at iter_precision='high'
    (row high_prec_ms: f32 products in TF32 on the H100's tensor cores) and
    'bf16' (row bf16_ms: bf16 products and bf16-stored blocks/amplitudes);
    refine=True recovers 1e-8 parity, tested.

    measure_solve: additionally time a full CONVERGING solve (diis='tl',
    conv 'tl' to 1e-6 — the production configuration; DIIS cuts pVTZ from
    47 to 15 iterations) — solve_ms is wall-clock-to-solution, the
    end-user-facing number."""
    import jax
    import jax.numpy as jnp
    from ecw_cc_tpu.models.eris import GEris, build_eris_device
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    from ecw_cc_tpu.ops.ladder import resolve_mode

    mol, ghf = build_host(basis)
    nocc_g = int(np.sum(ghf.mo_occ > 0))
    nvir_g = ghf.mo_coeff.shape[1] - nocc_g
    vvvv_op = None
    mo_perm = None
    if resolve_mode(nvir_g) == "packed":
        # production route: dense v^4 never materialized (pack-on-build);
        # spin-sorted layout (default) -> block-diagonal SectoredVVVV
        # (2.67x fewer ladder FLOPs than PackedVVVV).  r4: the pVDZ row
        # runs this too (crossover gate moved to nvir >= 48) — the NumPy
        # baseline gets its dense f64 blocks from the HOST builder below
        import ecw_cc_tpu.config as _cfg
        from ecw_cc_tpu.ops.ladder import spin_sort_perm
        sort = bool(_cfg.get_config().spin_sorted)
        eris, vvvv_op = build_eris_device(mol, ghf, dtype="float32",
                                          pack_ladder=True, sort_spin=sort)
        if sort:
            mo_perm = spin_sort_perm(ghf.orbspin, nocc_g)
    else:
        # the NumPy-baseline step needs the dense block
        eris = build_eris_device(mol, ghf, dtype="float32")
    dtype = jnp.float32
    nmo = eris.fock.shape[0]
    target_np = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    target = jnp.asarray(target_np, dtype=dtype)

    # production solver, fixed iteration count (conv_thres=0 -> maxiter path)
    mycc = GCC(eris)
    exp = Exp(LW, [[["mat", target_np]]], mol=mol, mo_coeff=ghf.mo_coeff)
    solver = Solver_CCSD(mycc, exp, conv="tl", conv_thres=0.0, diis="",
                         maxiter=n_iters, vvvv_op=vvvv_op, mo_perm=mo_perm)
    run = solver._build_device_solver("", False)
    Lw = jnp.asarray(solver.myVexp.L_check(LW)[0], dtype=dtype)
    alpha_v = jnp.asarray(0.0, dtype=dtype)
    args = (solver.tsini, solver.lsini, solver.tdini, solver.ldini)

    vvsect_dev = solver._get_vvvv_op()
    out = run(eris, vvsect_dev, Lw, *args, alpha_v)   # compile + first run
    k = int(out[6])                        # iterations executed
    _ = float(out[8][k - 1])               # scalar value fetch: waits
    assert k >= n_iters, f"expected >= {n_iters} iterations, got {k}"

    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = run(eris, vvsect_dev, Lw, *args, alpha_v)
        ep = float(out[8][k - 1])          # forces execution, scalar only
        best = min(best, (time.perf_counter() - t0) / k * 1e3)
    assert np.isfinite(ep)
    dev_ms = best

    # FLOPs of one iteration (XLA cost model on CPU shapes), counting the
    # SAME path the solver ran (sectored vvvv when auto-enabled); step
    # signature is (eris, sect, t1, t2, l1, l2) while args is (ts,ls,td,ld)
    vvsect = vvsect_dev
    # tree.map preserves the operand type (PackedVVVV / sector tuple) —
    # a plain tuple() would break the isinstance dispatch in apply_vvvv_op
    sect_shapes = (None if vvsect is None else
                   jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, dtype),
                                vvsect))
    import ecw_cc_tpu.config as _cfg2
    sect_info = None
    sect_sym = False
    if (mo_perm is not None and solver._sinfo is not None
            and _cfg2.get_config().soup_sector
            and solver._vexp_block_diagonal()):
        sect_info = solver._sinfo
        sect_sym = (_cfg2.get_config().soup_sym
                    and solver._spin_restricted())
    step = device_full_step(target_np.astype(np.float32), np.float32(LW),
                            sect_info=sect_info, sym=sect_sym)
    shapes = [jax.ShapeDtypeStruct(a.shape, dtype)
              for a in (args[0], args[2], args[1], args[3])]
    eris_shapes = GEris(**{f: jax.ShapeDtypeStruct(getattr(eris, f).shape, dtype)
                           for f in GEris._fields})
    flops = count_flops(step, eris_shapes, (sect_shapes,) + tuple(shapes))
    tflops = flops / (dev_ms * 1e-3) / 1e12 if np.isfinite(flops) else None

    result = {"value_ms": round(dev_ms, 3),
              "tflops": round(tflops, 2) if tflops else None,
              "flops_per_iter": None if not np.isfinite(flops) else int(flops),
              "iters_timed": k}

    if vvsect is not None:
        # FLOPs of the DENSE step too (dense ladder AND dense kernels): the
        # NumPy reference engine runs the dense route, so baseline
        # extrapolation must not use the packed/sectored counts
        nv = eris.nvir
        eris_shapes_d = eris_shapes._replace(
            vvvv=jax.ShapeDtypeStruct((nv, nv, nv, nv), dtype))
        step_d = device_full_step(target_np.astype(np.float32),
                                  np.float32(LW))
        flops_d = count_flops(step_d, eris_shapes_d, (None,) + tuple(shapes))
        if np.isfinite(flops_d):
            result["flops_per_iter_dense"] = int(flops_d)
            # dense-EQUIVALENT throughput: the sectored/sym kernels cut the
            # step's useful FLOPs up to ~11x, so the raw tflops figure
            # DROPS as the step gets faster — this field is the
            # apples-to-apples number (dense-step FLOPs / measured time)
            result["tflops_dense_equiv"] = round(
                flops_d / (dev_ms * 1e-3) / 1e12, 2)

    if measure_high:
        import ecw_cc_tpu.config as config

        try:
            for mode, tag in (("high", "high_prec"), ("bf16", "bf16")):
                config.set_config(iter_precision=mode)
                exp_h = Exp(LW, [[["mat", target_np]]], mol=mol,
                            mo_coeff=ghf.mo_coeff)
                solver_h = Solver_CCSD(GCC(eris), exp_h, conv="tl",
                                       conv_thres=0.0, diis="",
                                       maxiter=n_iters, vvvv_op=vvvv_op,
                                       mo_perm=mo_perm)
                run_h = solver_h._build_device_solver("", False)
                out = run_h(eris, vvsect_dev, Lw, *args, alpha_v)
                kh = int(out[6])
                _ = float(out[8][kh - 1])
                best_h = np.inf
                for _ in range(3):
                    t0 = time.perf_counter()
                    out = run_h(eris, vvsect_dev, Lw, *args, alpha_v)
                    _ = float(out[8][kh - 1])
                    best_h = min(best_h,
                                 (time.perf_counter() - t0) / kh * 1e3)
                result[f"{tag}_ms"] = round(best_h, 3)
                if np.isfinite(flops):
                    result[f"{tag}_tflops"] = round(
                        flops / (best_h * 1e-3) / 1e12, 2)
        finally:
            config.set_config(iter_precision="highest")

    if measure_solve:
        exp_s = Exp(LW, [[["mat", target_np]]], mol=mol,
                    mo_coeff=ghf.mo_coeff)
        solver_s = Solver_CCSD(GCC(eris), exp_s, conv="tl", conv_thres=1e-6,
                               diis="tl", maxiter=100, vvvv_op=vvvv_op,
                               mo_perm=mo_perm)
        run_s = solver_s._build_device_solver("tl", False)
        out = run_s(eris, vvsect_dev, Lw, *args, alpha_v)
        ks = int(out[6])
        _ = float(out[8][ks - 1])
        best_s = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            out = run_s(eris, vvsect_dev, Lw, *args, alpha_v)
            # one batched result transfer for k and Ep
            k_h, ep_h = jax.device_get((out[6], out[8]))
            _ = float(ep_h[int(k_h) - 1])
            best_s = min(best_s, (time.perf_counter() - t0) * 1e3)
        result["solve_ms"] = round(best_s, 1)
        result["solve_iters"] = ks

    if numpy_baseline:
        cache = {}
        if os.path.exists(BASE_FILE):
            with open(BASE_FILE) as f:
                cache = json.load(f)
        numpy_ms, foreign = _baseline_lookup(cache, basis,
                                             allow_foreign=False)
        if numpy_ms is None:
            # dense f64 blocks for the reference engine from the HOST
            # builder (the device eris may be pack-on-build, no dense v^4)
            from ecw_cc_tpu.models.eris import build_eris
            host_eris = build_eris(mol, ghf)
            blocks = {f: np.asarray(getattr(host_eris, f), dtype=np.float64)
                      for f in GEris._fields}
            amps = mp2_amps(blocks)
            numpy_full_step(blocks, *amps, target_np, LW)   # warm-up
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                numpy_full_step(blocks, *amps, target_np, LW)
                times.append((time.perf_counter() - t0) * 1e3)
            numpy_ms = min(times)
            foreign = False
            cache[f"{basis}_v{STEP_VERSION}_{_cpu_host_key()}"] = numpy_ms
            tmp = BASE_FILE + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cache, f)
            os.replace(tmp, BASE_FILE)
        result["numpy_ms"] = round(numpy_ms, 1)
        result["vs_baseline"] = round(numpy_ms / dev_ms, 2)
        if foreign:
            result["baseline_foreign_host"] = True
    return result


def bench_t(basis="cc-pvtz"):
    """Sectored vs dense (T) energy on the device (the round-3 kernel:
    ops/ccsd_t.energy_t_sect — per-spin-sector-pair scans, ~8-16x fewer
    FLOPs).  MP2 amplitudes; the value only sanity-anchors the routes."""
    import jax
    import jax.numpy as jnp
    from ecw_cc_tpu.models.gamma_exp import _build_eris_sorted
    from ecw_cc_tpu.ops import ccsd_t

    mol, ghf = build_host(basis)
    # the PRODUCTION sorted-build recipe (one definition; bench must not
    # measure a different route than target generation runs)
    eris, vvvv_op, sect, _ = _build_eris_sorted(mol, ghf)
    info, sym = sect
    nocc = eris.nocc
    diag = jnp.diag(eris.fock)
    eia = diag[:nocc, None] - diag[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t2 = eris.oovv / eijab
    t1 = jnp.zeros_like(eia)

    def timeit(fn):
        f = jax.jit(fn)
        val = float(f(eris, t1, t2))  # compile + value fetch
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            val = float(f(eris, t1, t2))
            best = min(best, time.perf_counter() - t0)
        return round(best * 1e3, 1), val

    dense_ms, e_d = timeit(lambda er, a, b: ccsd_t.energy_t(er, a, b))
    sect_ms, e_s = timeit(lambda er, a, b: ccsd_t.energy_t_sect(
        er, a, b, info, sym=sym))
    # reduced-precision slabs (r4: bf16 streams + full-precision
    # accumulation; tested rel bound 5e-3, tests/test_ccsd_t.py)
    bf16_ms, e_b = timeit(lambda er, a, b: ccsd_t.energy_t_sect(
        er, a, b, info, sym=sym, slab_dtype="bfloat16"))
    return {"dense_ms": dense_ms, "sect_ms": sect_ms, "sym": bool(sym),
            "speedup": round(dense_ms / sect_ms, 1),
            "e_match": bool(abs(e_d - e_s) < 5e-4 * max(1.0, abs(e_d))),
            "bf16_ms": bf16_ms,
            "bf16_rel_err": round(abs(e_b - e_s) / max(abs(e_s), 1e-12), 6),
            "bf16_e_match": bool(abs(e_b - e_s) < 5e-3 * max(1.0, abs(e_s)))}


def bench_es():
    """ES production path on device at PRODUCTION scale and PRODUCTION
    precision (f32): the fully-jitted coupled multi-state ES solver
    (SolverES_Device) on the reference's ES demonstration config —
    H2O/6-31++g** with the two QChem transition-dipole targets
    (/root/reference/test/Test_ECW_ES.py:1-50, gamma_exp.py:27-94).
    Returns per-iteration ms (fixed 20-iteration run) and converging
    solve_ms (diis='all', conv 'rl' 1e-5, L=0.1).

    Runs IN the parent bench process under its f32 config (r5): the r4
    claim that the diffuse-basis ES fixed point is unstable under f32 was
    a LAYOUT artifact — the measurement fed alternating-convention
    amplitudes into the spin-SORTED ecw.eris; with the correct
    alternating-layout eris (ecw._eris_alt(), same handle CCS_ES uses) the
    f32 state matches f64 exactly (7.1335 / 10.0701 eV, cold start and
    f64-seeded; tools/es_f32_drift_r5.py, pinned by
    tests/test_es.py::test_f32_es_holds_f64_state_production_basis).  f64
    host parity: tests/test_es.py::test_device_es_solver_production_basis."""
    import jax.numpy as jnp
    from ecw_cc_tpu import ECW
    from ecw_cc_tpu.ops.ccs import Gccs
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.es import Solver_ES, SolverES_Device

    ecw = ECW("h2o", "6-31++g**")
    dip1 = (0.523742 + 0.550251) / 2.0
    dip2 = (0.622534 + 0.649058) / 2.0
    ecw.Build_ES_exp_input([[["trdip", (dip1, 0.0, 0.0)]],
                            [["trdip", (0.0, 0.0, dip2)]]])
    L = 0.1
    # the ES solvers take eris in the reference (alternating) MO
    # convention; under the f32 production config ecw.eris is spin-sorted
    eris = ecw._eris_alt()

    # per-iteration: fixed-count run of the while_loop body
    Vi = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    s_it = Solver_ES(Gccs(eris), Vi, rn_ini=ecw.r_ini, conv_var="rl",
                     conv_thres=0.0, maxiter=20, diis="all")
    dev_it = SolverES_Device(s_it)
    out = dev_it.SCF(L)            # compile + run (maxiter path)
    best_it = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = dev_it.SCF(L)
        best_it = min(best_it, (time.perf_counter() - t0) / 20 * 1e3)
    # converging solve (the end-user number)
    Vs = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    s_sv = Solver_ES(Gccs(eris), Vs, rn_ini=ecw.r_ini, conv_var="rl",
                     conv_thres=1e-5, maxiter=80, diis="all")
    dev_sv = SolverES_Device(s_sv)
    out = dev_sv.SCF(L)
    best_sv = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        out = dev_sv.SCF(L)
        best_sv = min(best_sv, (time.perf_counter() - t0) * 1e3)
    text = out[0]
    n_it = 0
    for tok in text.replace(",", " ").split():
        if tok.isdigit():
            n_it = int(tok)
    e1_ev = float(np.asarray(out[3])[1, 0]) * 27.2114
    e2_ev = float(np.asarray(out[3])[2, 0]) * 27.2114
    return {"basis": "6-31++g**", "dtype": "float32",
            "value_ms": round(best_it, 3), "solve_ms": round(best_sv, 1),
            "solve_iters": n_it, "converged": "Convergence reached" in text,
            "E_es1_eV": round(e1_ev, 3), "E_es2_eV": round(e2_ev, 3)}


def bench_ee(eris, t1, t2, vvvv_op):
    """EOM-EE-CCSD wall-clock on C2H2/cc-pVDZ (shares the converged
    CCSD amplitudes with bench_ipea): warm Davidson time-to-solution for
    the lowest EE root (right only — comparable to the r4 BASELINE.md
    table) and for 2 roots WITH left eigenvectors (the r5 block left
    solve, ops/eom.py).  No EE number existed in any BENCH artifact before
    r5."""
    from ecw_cc_tpu.ops.eom import eom_ccsd

    w1, _ = eom_ccsd(eris, t1, t2, nroots=1, tol=1e-5, vvvv_op=vvvv_op)
    best_r = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        w1, _ = eom_ccsd(eris, t1, t2, nroots=1, tol=1e-5, vvvv_op=vvvv_op)
        best_r = min(best_r, (time.perf_counter() - t0) * 1e3)
    wb, _, _ = eom_ccsd(eris, t1, t2, nroots=2, tol=1e-5, left=True,
                        vvvv_op=vvvv_op)
    best_b = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        wb, _, _ = eom_ccsd(eris, t1, t2, nroots=2, tol=1e-5, left=True,
                            vvvv_op=vvvv_op)
        best_b = min(best_b, (time.perf_counter() - t0) * 1e3)
    return {"ee_solve_ms": round(best_r, 1),
            "ee_left2_solve_ms": round(best_b, 1),
            "ee1_eV": round(w1[0] * 27.2114, 3),
            "ee2_eV": round(wb[1] * 27.2114, 3)}


def bench_ipea():
    """EOM-IP/EA-CCSD (Wick-derived sigma, ops/eom_ipea.py) wall-clock on
    C2H2/cc-pVDZ: plain-CCSD solve is shared with the GS rows; reported is
    the Davidson time-to-solution for 2 IP + 1 EA roots (f32, packed
    ladder) plus the energies — a NEW capability row (no reference
    counterpart)."""
    import jax.numpy as jnp
    from ecw_cc_tpu.models.eris import build_eris_device
    from ecw_cc_tpu.ops.ccsd_t import solve_ccsd
    from ecw_cc_tpu.ops.eom_ipea import eom_ea_ccsd, eom_ip_ccsd
    from ecw_cc_tpu.ops.ladder import pack_vvvv

    mol, ghf = build_host("cc-pvdz")
    eris = build_eris_device(mol, ghf, dtype="float32")
    vvvv_op = pack_vvvv(eris.vvvv)
    t1, t2, _ = solve_ccsd(eris, conv_tol=1e-8, vvvv_op=vvvv_op)
    # warm-up (compiles the sigma programs)
    w_ip, _ = eom_ip_ccsd(eris, t1, t2, nroots=2, tol=1e-5)
    w_ea, _ = eom_ea_ccsd(eris, t1, t2, nroots=1, tol=1e-5,
                          vvvv_op=vvvv_op)
    best_ip = best_ea = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        w_ip, _ = eom_ip_ccsd(eris, t1, t2, nroots=2, tol=1e-5)
        best_ip = min(best_ip, (time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        w_ea, _ = eom_ea_ccsd(eris, t1, t2, nroots=1, tol=1e-5,
                              vvvv_op=vvvv_op)
        best_ea = min(best_ea, (time.perf_counter() - t0) * 1e3)
    row = {"ip_solve_ms": round(best_ip, 1), "ea_solve_ms": round(best_ea, 1),
           "ip1_eV": round(w_ip[0] * 27.2114, 3),
           "ea1_eV": round(w_ea[0] * 27.2114, 3)}
    return row, (eris, t1, t2, vvvv_op)


def main():
    import jax

    import ecw_cc_tpu.config as config

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; the default JAX device "
                         f"is {dev.platform!r}")
    which = os.environ.get("ECW_CC_TPU_BENCH", "both")

    config.set_config(x64=False, dtype="float32")
    config.setup_jax()

    # ES production row at production precision (f32 holds the
    # diffuse-basis state, see bench_es docstring)
    es_row = bench_es() if which == "both" else None

    pvdz = bench_config("cc-pvdz", n_iters=40, numpy_baseline=True)

    pvtz = None
    if which != "pvdz":
        pvtz = bench_config("cc-pvtz", n_iters=40, numpy_baseline=False,
                            measure_high=True)
        # MEASURED pVTZ NumPy baseline when available (tools/
        # measure_numpy_baseline.py runs the ~15 min/iter dense NumPy step
        # offline and caches it under the same STEP_VERSION key) ...
        cache = {}
        if os.path.exists(BASE_FILE):
            with open(BASE_FILE) as f:
                cache = json.load(f)
        meas, foreign = _baseline_lookup(cache, "cc-pvtz")
        if meas is not None:
            pvtz["numpy_ms"] = round(meas, 1)
            pvtz["vs_baseline"] = round(meas / pvtz["value_ms"], 2)
            if foreign:
                pvtz["baseline_foreign_host"] = True
        # ... otherwise estimated from measured pVDZ NumPy throughput
        # (FLOP/s) scaled to the pVTZ FLOP count; flagged as an estimate.
        elif pvdz.get("flops_per_iter") and pvtz.get("flops_per_iter"):
            # dense-route FLOPs on both sides: the NumPy engine always runs
            # the dense ladder
            np_flops_per_s = pvdz["flops_per_iter"] / (pvdz["numpy_ms"] * 1e-3)
            flops_np = pvtz.get("flops_per_iter_dense",
                                pvtz["flops_per_iter"])
            est_ms = flops_np / np_flops_per_s * 1e3
            pvtz["numpy_ms_est"] = round(est_ms, 1)
            pvtz["vs_baseline_est"] = round(est_ms / pvtz["value_ms"], 2)

    line = {
        "metric": "ecw_ccsd_full_iteration_c2h2_ccpvdz",
        "value": pvdz["value_ms"],
        "unit": "ms",
        "vs_baseline": pvdz.get("vs_baseline"),
        "tflops": pvdz.get("tflops"),
        "flops_per_iter": pvdz.get("flops_per_iter"),
        "solve_ms": pvdz.get("solve_ms"),
        "solve_iters": pvdz.get("solve_iters"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if pvtz is not None:
        line["pvtz"] = pvtz
    if which == "both":
        line["es"] = es_row
        line["ipea"], shared = bench_ipea()
        line["ee"] = bench_ee(*shared)
        if pvtz is not None:
            line["t_energy_pvtz"] = bench_t("cc-pvtz")
    print(json.dumps(line))


if __name__ == "__main__":
    main()
