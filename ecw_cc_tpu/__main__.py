"""Headless experiment runner: `python -m ecw_cc_tpu spec.json`.

The reference's workflow is editing its Main.py driver script in place
(reference Main.py __main__ usage; test/Test_ECW_GS.py, Test_ECW_ES.py are
such edited copies).  This runner supplies the same workflow as data: one
JSON spec per experiment, so production sweeps run unattended (cron/CI)
with the results table on stdout.

Spec format (all keys but molecule/basis optional):

{
  "molecule": "h2o",            // catalog name or raw geometry string
  "basis": "6-31g",
  "out_dir": "results",         // cube files / plots / output.txt
  "dtype": "float32",           // config.set_config override (x64 follows)
  "config": {"soup_sector": true},           // extra config fields
  "target": {"prop": "mat", "posthf": "HF",  // Build_GS_exp args
             "field": [0.05, 0.01, 0.0]},
  "es_targets": {"mom": [1, 0]} | {"eom": 2, "eom_prop": "trdip"} |
                {"input": [[["trdip", [0.54, 0.0, 0.0]]]]},
  "run": {
    "solver": "CCSD_GS",        // CCS_GS | CCSD_GS | CCS_ES
    "Larray": [0.0, 0.7, 8],    // np.linspace(start, stop, n); or a list
    ...                         // remaining keys passed to the solver
  }
}
"""

from __future__ import annotations

import json
import sys

import numpy as np


def _larray(spec):
    arr = spec.get("Larray", [0.5, 0.5, 1])
    if len(arr) == 3 and isinstance(arr[2], int) and arr[2] > 0:
        return np.linspace(arr[0], arr[1], arr[2])
    return np.asarray(arr, dtype=float)


def build_ecw(spec):
    """Apply the spec's config, build the ECW driver and its targets."""
    import ecw_cc_tpu.config as config

    dtype = spec.get("dtype")
    if dtype is not None:
        config.set_config(x64=(dtype == "float64"), dtype=dtype)
    if spec.get("config"):
        config.set_config(**spec["config"])
    config.setup_jax()

    from ecw_cc_tpu import ECW

    ecw = ECW(spec["molecule"], spec["basis"],
              out_dir=spec.get("out_dir"))

    target = dict(spec.get("target", {"prop": "mat", "posthf": "HF"}))
    ecw.Build_GS_exp(**target)

    es = spec.get("es_targets")
    if es:
        if "mom" in es:
            ecw.Build_ES_exp_MOM(tuple(es["mom"]))
        elif "eom" in es:
            ecw.Build_ES_exp_EOM(int(es["eom"]),
                                 prop=es.get("eom_prop", "trmat"))
        elif "input" in es:
            ecw.Build_ES_exp_input(es["input"])
        else:
            raise ValueError(f"unknown es_targets spec: {es}")
    return ecw


def run_solver(ecw, run):
    """Run the spec's "run" section on a built driver; returns the solver
    results (per-lambda records stay on the driver, e.g. ecw.Delta_lamb)."""
    run = dict(run)
    solver = run.pop("solver", "CCSD_GS")
    if solver in ("CCS_GS", "CCSD_GS"):
        L = _larray(run)
        run.pop("Larray", None)
        results = getattr(ecw, solver)(L, **run)
        ecw.print_results()
        return results
    if solver == "CCS_ES":
        L = run.pop("L", run.pop("Larray", [0.1])[0])
        results = ecw.CCS_ES(L, **run)
        ecw.print_results_ES()
        return results
    raise ValueError(f"unknown solver {solver!r} "
                     "(use CCS_GS, CCSD_GS or CCS_ES)")


def run_spec(spec):
    """Execute one experiment spec; returns the solver results."""
    return run_solver(build_ecw(spec),
                      spec.get("run", {"solver": "CCSD_GS"}))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        print("usage: python -m ecw_cc_tpu spec.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        spec = json.load(f)
    run_spec(spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
