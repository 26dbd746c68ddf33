"""Reproduce + diagnose the f32 ES fixed-point drift.

The coupled ES solve at the production config (H2O/6-31++g**, two QChem
trdip targets, /root/reference/test/Test_ECW_ES.py:1-50) converges to
E_es1 = 7.13 eV in f64 but drifts to a different self-consistent state
(9.11 eV, r4 measurement) when the iteration map runs in f32.  This tool
runs each precision in its own subprocess (exact production dtype config,
CPU backend) and prints the E1 trajectory so mitigation candidates can be
measured.

Usage:  python tools/es_f32_drift_r5.py            # orchestrates both
        python tools/es_f32_drift_r5.py f64        # subprocess modes
        python tools/es_f32_drift_r5.py f32 <seed.npz> <maxiter>
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
STATE = "/tmp/es_f64_state.npz"


def build():
    import numpy as np
    from ecw_cc_tpu import ECW

    ecw = ECW("h2o", "6-31++g**")
    dip1 = (0.523742 + 0.550251) / 2.0
    dip2 = (0.622534 + 0.649058) / 2.0
    ecw.Build_ES_exp_input([[["trdip", (dip1, 0.0, 0.0)]],
                            [["trdip", (0.0, 0.0, dip2)]]])
    return ecw


def solve_f64():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ecw_cc_tpu.config as config
    config.set_config(x64=True, dtype="float64")
    config.setup_jax()
    import numpy as np
    from ecw_cc_tpu.ops.ccs import Gccs
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.es import Solver_ES, SolverES_Device

    ecw = build()
    L = 0.1
    V = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    s = Solver_ES(Gccs(ecw.eris), V, rn_ini=ecw.r_ini, conv_var="rl",
                  conv_thres=1e-7, maxiter=120, diis="all")
    out = SolverES_Device(s).SCF(L)
    text, dic, _, Ep = out[0], out[1], out[2], np.asarray(out[3])
    e1 = Ep[1, 0] * 27.2114
    e2 = Ep[2, 0] * 27.2114
    np.savez(STATE, ts=dic["ts"], ls=dic["ls"],
             rn=np.stack(dic["rn"]), ln=np.stack(dic["ln"]),
             r0n=np.asarray(dic["r0n"]), l0n=np.asarray(dic["l0n"]))
    print("F64ROW " + json.dumps({
        "converged": "Convergence reached" in text,
        "E1_eV": round(float(e1), 4), "E2_eV": round(float(e2), 4)}),
        flush=True)


def run_f32(seed_path, maxiter, mixed=None):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ecw_cc_tpu.config as config
    config.set_config(x64=False, dtype="float32")
    config.setup_jax()
    import numpy as np
    from ecw_cc_tpu.ops.ccs import Gccs
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.solvers.es import Solver_ES, SolverES_Device

    ecw = build()
    L = 0.1
    z = np.load(seed_path)
    dic = {"ts": z["ts"], "ls": z["ls"], "rn": list(z["rn"]),
           "ln": list(z["ln"]), "r0n": z["r0n"], "l0n": z["l0n"]}
    rows = []
    # NB: the ES solvers take eris in the reference (alternating) MO
    # convention — under the f32 production config ecw.eris is the
    # spin-SORTED layout; feeding it directly (as the r4 drift measurement
    # did) scrambles the physics.  ecw._eris_alt() is the correct handle
    # (models/ecw.py CCS_ES does the same).
    eris = ecw._eris_alt()
    for n in maxiter:
        V = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
        s = Solver_ES(Gccs(eris), V, rn_ini=ecw.r_ini, conv_var="rl",
                      conv_thres=0.0, maxiter=n, diis="all")
        out = SolverES_Device(s).SCF(L, dic_amp_ini={k: (np.asarray(v)
                                                         if not isinstance(v, list)
                                                         else [np.asarray(x) for x in v])
                                                     for k, v in dic.items()})
        Ep = np.asarray(out[3])
        rows.append({"iters": n, "E1_eV": round(float(Ep[1, 0]) * 27.2114, 4),
                     "E2_eV": round(float(Ep[2, 0]) * 27.2114, 4)})
    print("F32ROW " + json.dumps(rows), flush=True)


def main():
    env = dict(os.environ)
    me = os.path.abspath(__file__)
    if not os.path.exists(STATE):
        r = subprocess.run([sys.executable, me, "f64"], env=env)
        assert r.returncode == 0
    r = subprocess.run([sys.executable, me, "f32", STATE,
                        "1,2,5,10,20,40,80"], env=env)
    assert r.returncode == 0


if __name__ == "__main__":
    if len(sys.argv) == 1:
        main()
    elif sys.argv[1] == "f64":
        solve_f64()
    else:
        run_f32(sys.argv[2], [int(x) for x in sys.argv[3].split(",")])
