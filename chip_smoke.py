"""Smoke run of ECW-CC's main paths on one GPU, checked against references.

Run:  python chip_smoke.py        (needs one CUDA device; no arguments)

Phases, each in this process on the default JAX device, each printing one
result line with its wall seconds (cold: compilation included), the numbers
compared and their limits:

  device       the default device is a GPU; there is no CPU fallback
  step_parity  one production iteration on C2H2/cc-pVDZ (spin-sorted
               sector-blocked f32 route at 'highest', and the dense f64
               kernels) against bench.numpy_full_step, the plain f64 NumPy
               reference; (T) sectored against dense
  gs_flagship  C2H2/6-311++G(2d,2p) CCSD lambda sweep against a CCSD(T)
               'mat' target through the headless runner (ecw_cc_tpu.__main__)
  es           H2O/6-31++G** coupled ES solve (SolverES_Device, f32) against
               the f64 energies pinned in tests/test_es.py
  eom          Build_ES_exp_EOM(2, 'trdip') on H2O/6-31G, f32 on the GPU
               against f64 on the CPU backend

Any failed check raises: the exit code is non-zero and the last line is not
printed.  The last line of a healthy run is exactly
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""

import json
import subprocess
import time

import numpy as np

EV = 27.2114          # Hartree -> eV, as in tests/test_es.py
LW = 0.01             # the bench's constraint weight for the step check

# Limits.  Each names the effect that sets it.
# f32 step: one iteration from MP2 amplitudes; f32 rounding of O(1e2)-term
# sums whose order XLA's autotuned GEMM algorithms choose.
F32_AMP_REL = 1e-5    # max|d amp| / max|t2|
F32_EP_ABS = 1e-6     # Eh
# f64 step: the same algebra as the NumPy reference in another sum order.
F64_AMP_REL = 1e-10
F64_EP_ABS = 1e-10
# (T): sectored and dense scans add the same f32 terms in another order.
T_REL = 1e-6
# Flagship: the published-reference anchor of README's flagship run, given
# to 4 decimals; f32 target generation (CCSD(T) energy) is good to ~1e-6.
EEXP_ANCHOR, EEXP_ABS = -77.1995, 1e-3
EHF_ANCHOR, EHF_ABS = -76.8462, 1e-4      # printed to 4 decimals
# ES: f64 CPU anchors of tests/test_es.py; the f32 solve converges to the
# same state (conv 1e-5 in 'rl'), f32 rounding of the state energies.
ES_ANCHORS_EV, ES_ABS_EV = (7.1335, 10.0701), 1e-3
# EOM: f32 Davidson against f64 (tests/test_eom.py bound): f32 rounding in
# the sigma products, Davidson residual tol 1e-5 in f32.
EOM_ABS = 2e-5


def _line(name, seconds, **fields):
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {seconds:.1f} s {body}", flush=True)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _fmt(x):
    return f"{float(x):.3e}"


def gpu_device():
    """The default device; raises unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"default JAX device is {dev.platform!r}, not a GPU; "
                           "chip_smoke runs on the GPU only")
    return dev


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def _host_system(molecule, basis):
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.models.scf import GHF, RHF

    mol = Molecule(molecule, basis)
    mf = RHF(mol)
    mf.kernel()
    return mol, GHF(mf)


def _maxdiff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, dtype=np.float64) - y)))
               for x, y in zip(a, b))


def step_parity(molecule="c2h2", basis="cc-pvdz", L=LW):
    """One production iteration from MP2 amplitudes on the default device,
    f32 on the spin-sorted sector-blocked route (the solver's own gates) and
    f64 on the dense kernels, each compared with bench.numpy_full_step.

    Returns {"f32": (amp_diff, ep_diff), "f64": (...), "scale": max|t2|,
    "route": (...)}: diffs in the reference MO layout."""
    import jax
    import jax.numpy as jnp

    import ecw_cc_tpu.config as config
    from bench import device_full_step, mp2_amps, numpy_full_step
    from ecw_cc_tpu.models.eris import GEris, build_eris, build_eris_device
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.ladder import (SectoredVVVV, resolve_mode,
                                       spin_sort_perm)
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.gs import Solver_CCSD, _perm4

    mol, ghf = _host_system(molecule, basis)
    host = build_eris(mol, ghf)
    blocks = {f: np.asarray(getattr(host, f), dtype=np.float64)
              for f in GEris._fields}
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    amps = mp2_amps(blocks)                          # (t1, t2, l1, l2)
    ref = numpy_full_step(blocks, *amps, target, L)  # (t1, t2, l1, l2, Ep)
    scale = float(np.max(np.abs(ref[1])))
    nocc = amps[0].shape[0]

    cfg_was = config.get_config()
    cfg_was = dict(x64=cfg_was.x64, dtype=cfg_was.dtype)
    try:
        # --- f32 production route (sorted layout, sectored + sym) -----------
        config.set_config(x64=False, dtype="float32")
        config.setup_jax()
        _check(jax.config.jax_default_matmul_precision == "highest",
               "matmul precision is not 'highest'")
        nvir = amps[0].shape[1]
        _check(resolve_mode(nvir) == "packed",
               f"nvir={nvir} does not take the packed route")
        eris, sect = build_eris_device(mol, ghf, dtype="float32",
                                       pack_ladder=True, sort_spin=True)
        _check(isinstance(sect, SectoredVVVV), "ladder operand not sectored")
        perm = spin_sort_perm(ghf.orbspin, nocc)
        solver = Solver_CCSD(GCC(eris), Exp(L, [[["mat", target]]], mol=mol,
                                            mo_coeff=ghf.mo_coeff),
                             vvvv_op=sect, mo_perm=perm)
        _check(solver._vexp_block_diagonal(), "sector gate is off")
        sym = bool(solver._spin_restricted())
        _check(sym, "mirror-symmetry gate is off")
        po, pv = perm[:nocc], perm[nocc:] - nocc
        io, iv = np.argsort(po), np.argsort(pv)
        t1, t2, l1, l2 = amps
        sorted_in = [jnp.asarray(a, dtype=jnp.float32) for a in (
            t1[np.ix_(po, pv)], _perm4(t2, po, pv),
            l1[np.ix_(po, pv)], _perm4(l2, po, pv))]
        step = jax.jit(device_full_step(
            target[np.ix_(perm, perm)].astype(np.float32), np.float32(L),
            sect_info=solver._sinfo, sym=sym))
        out = jax.device_get(step(eris, sect, *sorted_in))
        f32 = [out[0][np.ix_(io, iv)], _perm4(out[1], io, iv),
               out[2][np.ix_(io, iv)], _perm4(out[3], io, iv)]
        f32_res = (_maxdiff(f32, ref[:4]), abs(float(out[4]) - ref[4]))

        # --- f64 dense kernels (the default-dtype route) ---------------------
        config.set_config(x64=True, dtype="float64")
        config.setup_jax()
        eris64 = host.to_device(dtype="float64")
        step64 = jax.jit(device_full_step(target, L))
        out64 = jax.device_get(step64(
            eris64, None, *[jnp.asarray(a, dtype=jnp.float64) for a in amps]))
        f64_res = (_maxdiff(out64[:4], ref[:4]), abs(float(out64[4]) - ref[4]))
    finally:
        config.set_config(**cfg_was)
        config.setup_jax()
    return {"f32": f32_res, "f64": f64_res, "scale": scale,
            "route": ("packed", "sectored", "sym")}


def t_parity(molecule="c2h2", basis="cc-pvdz"):
    """(T) energy from MP2 amplitudes, sector-blocked scans against the
    dense scans, both f32 on the default device (sorted production layout)."""
    import jax
    import jax.numpy as jnp

    import ecw_cc_tpu.config as config
    from ecw_cc_tpu.models.gamma_exp import _build_eris_sorted
    from ecw_cc_tpu.ops import ccsd_t

    cfg_was = config.get_config()
    cfg_was = dict(x64=cfg_was.x64, dtype=cfg_was.dtype)
    try:
        config.set_config(x64=False, dtype="float32")
        config.setup_jax()
        mol, ghf = _host_system(molecule, basis)
        eris, _, (info, sym), _ = _build_eris_sorted(mol, ghf)
        diag = jnp.diag(eris.fock)
        eia = diag[:eris.nocc, None] - diag[None, eris.nocc:]
        t2 = eris.oovv / (eia[:, None, :, None] + eia[None, :, None, :])
        t1 = jnp.zeros_like(eia)
        e_dense = float(jax.jit(ccsd_t.energy_t)(eris, t1, t2))
        e_sect = float(jax.jit(lambda er, a, b: ccsd_t.energy_t_sect(
            er, a, b, info, sym=sym))(eris, t1, t2))
    finally:
        config.set_config(**cfg_was)
        config.setup_jax()
    return e_dense, e_sect


def flagship_spec(n_lambda=3):
    """The reference's flagship GS deployment as a headless-runner spec."""
    return {
        "molecule": "c2h2", "basis": "6-311++g(2d,2p)", "dtype": "float32",
        "target": {"prop": "mat", "posthf": "CCSD(T)"},
        "run": {"solver": "CCSD_GS", "Larray": [0.0, 0.7, n_lambda],
                "diis": "tl", "conv_thres": 1e-6, "maxiter": 80},
    }


def phase_step_parity():
    t0 = time.perf_counter()
    r = step_parity()
    s = r["scale"]
    (a32, e32), (a64, e64) = r["f32"], r["f64"]
    e_dense, e_sect = t_parity()
    t_rel = abs(e_sect - e_dense) / abs(e_dense)
    _line("step_parity", time.perf_counter() - t0,
          route="+".join(r["route"]), max_t2=_fmt(s),
          f32_amp=f"{_fmt(a32)}<={_fmt(F32_AMP_REL * s)}",
          f32_Ep=f"{_fmt(e32)}<={_fmt(F32_EP_ABS)}",
          f64_amp=f"{_fmt(a64)}<={_fmt(F64_AMP_REL * s)}",
          f64_Ep=f"{_fmt(e64)}<={_fmt(F64_EP_ABS)}",
          T_dense=f"{e_dense:.9f}", T_sect=f"{e_sect:.9f}",
          T_rel=f"{_fmt(t_rel)}<={_fmt(T_REL)}")
    _check(a32 <= F32_AMP_REL * s, "f32 step amplitudes off the reference")
    _check(e32 <= F32_EP_ABS, "f32 step energy off the reference")
    _check(a64 <= F64_AMP_REL * s, "f64 step amplitudes off the reference")
    _check(e64 <= F64_EP_ABS, "f64 step energy off the reference")
    _check(t_rel <= T_REL, "(T) sectored differs from dense")


def phase_gs_flagship():
    from ecw_cc_tpu.__main__ import build_ecw, run_solver

    t0 = time.perf_counter()
    spec = flagship_spec()
    ecw = build_ecw(spec)
    run_solver(ecw, spec["run"])
    conv = [t.startswith("Convergence reached") for t in ecw.conv_lamb]
    delta = [float(d) for d in ecw.Delta_lamb]
    falls = all(b < a for a, b in zip(delta, delta[1:]))
    ehf_scf = float(ecw._rhf.e_tot)
    _line("gs_flagship", time.perf_counter() - t0,
          lambdas=len(delta), converged=sum(conv),
          iters="/".join(str(n) for n in ecw.iters_lamb),
          delta="/".join(f"{d:.6f}" for d in delta), delta_falls=falls,
          EHF=f"{ecw.EHF:.6f}", EHF_scf=f"{ehf_scf:.6f}",
          EHF_anchor=f"{EHF_ANCHOR}+-{EHF_ABS}",
          Eexp=f"{ecw.Eexp_GS:.6f}", Eexp_anchor=f"{EEXP_ANCHOR}+-{EEXP_ABS}")
    _check(len(conv) == spec["run"]["Larray"][2] and all(conv),
           "a lambda point did not converge")
    _check(falls, "Delta does not fall strictly along the sweep")
    _check(ecw.EHF == ehf_scf, "EHF is not the host SCF energy")
    _check(abs(ecw.EHF - EHF_ANCHOR) <= EHF_ABS, "EHF off its anchor")
    _check(abs(ecw.Eexp_GS - EEXP_ANCHOR) <= EEXP_ABS,
           "Eexp(CCSD(T)) off its anchor")


def phase_es():
    from ecw_cc_tpu import ECW

    t0 = time.perf_counter()
    ecw = ECW("h2o", "6-31++g**")
    dip1 = (0.523742 + 0.550251) / 2.0
    dip2 = (0.622534 + 0.649058) / 2.0
    ecw.Build_ES_exp_input([[["trdip", (dip1, 0.0, 0.0)]],
                            [["trdip", (0.0, 0.0, dip2)]]])
    text, _, _, Ep, _ = ecw.CCS_ES(0.1, method="device", conv="rl",
                                   conv_thres=1e-5, maxiter=80, diis="all")
    Ep = np.asarray(Ep)
    e = (float(Ep[1, 0]) * EV, float(Ep[2, 0]) * EV)
    d = [abs(x - a) for x, a in zip(e, ES_ANCHORS_EV)]
    _line("es", time.perf_counter() - t0,
          converged="Convergence reached" in text,
          E1_eV=f"{e[0]:.5f}", E2_eV=f"{e[1]:.5f}",
          anchors=f"{ES_ANCHORS_EV}", max_dE_eV=f"{_fmt(max(d))}<={ES_ABS_EV}")
    _check("Convergence reached" in text, "ES solve did not converge")
    _check(max(d) <= ES_ABS_EV, "ES energies off the f64 anchors")


def _eom_roots(nroots=2):
    from ecw_cc_tpu import ECW

    ecw = ECW("h2o", "6-31g")
    ecw.Build_ES_exp_EOM(nroots, prop="trdip")
    return np.asarray(ecw.Eexp_ES[-1], dtype=np.float64)


def phase_eom():
    import jax

    import ecw_cc_tpu.config as config

    t0 = time.perf_counter()
    w32 = _eom_roots()
    t_gpu = time.perf_counter() - t0
    try:
        config.set_config(x64=True, dtype="float64")
        config.setup_jax()
        with jax.default_device(jax.devices("cpu")[0]):
            w64 = _eom_roots()
    finally:
        config.set_config(x64=False, dtype="float32")
        config.setup_jax()
    d = float(np.max(np.abs(w32 - w64)))
    _line("eom", time.perf_counter() - t0, gpu_s=f"{t_gpu:.1f}",
          w32_au="/".join(f"{w:.7f}" for w in w32),
          w64_cpu_au="/".join(f"{w:.7f}" for w in w64),
          max_dw_au=f"{_fmt(d)}<={_fmt(EOM_ABS)}")
    _check(d <= EOM_ABS, "f32 EOM roots off the f64 CPU roots")


def main():
    import jax

    t0 = time.perf_counter()
    dev = gpu_device()
    card = card_line()
    print(f"card: {card}", flush=True)

    import ecw_cc_tpu.config as config

    config.set_config(x64=False, dtype="float32")
    config.setup_jax()
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}", flush=True)
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}",
          flush=True)
    from ecw_cc_tpu import native

    t_nat = time.perf_counter()
    print(f"native ERI engine: {native.available()} "
          f"({time.perf_counter() - t_nat:.1f} s to build or load)", flush=True)
    _line("device", time.perf_counter() - t0, platform=dev.platform,
          kind=repr(dev.device_kind), count=len(jax.devices()))

    phase_step_parity()
    phase_gs_flagship()
    phase_es()
    phase_eom()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
