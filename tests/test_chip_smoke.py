"""CPU checks of what chip_smoke.py and bench.py run on the GPU.

The GPU phases themselves need the card; here: both scripts refuse to run
without one, the step-parity helper holds its limits on a small molecule
through the same sorted/sectored route, the compile-cache directory rule,
and the per-lambda records the flagship phase reads.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _cpu_env(**extra):
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_refuses_cpu(script):
    """No GPU: a non-zero exit and no result line, never a CPU fallback."""
    r = subprocess.run([sys.executable, script], cwd=REPO, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert '"metric"' not in r.stdout


def test_step_parity_sorted_route_matches_numpy():
    """The smoke's step-parity helper on H2O/6-31G with the packed route
    forced (ladder_packed_min_nvir=0), so the spin-sorted, sector-blocked,
    mirror-symmetric f32 step and the dense f64 kernels are both compared
    with bench.numpy_full_step at the smoke's own limits."""
    import ecw_cc_tpu.config as config

    config.set_config(ladder_packed_min_nvir=0)
    r = chip_smoke.step_parity("h2o", "6-31g")
    s = r["scale"]
    (a32, e32), (a64, e64) = r["f32"], r["f64"]
    assert r["route"] == ("packed", "sectored", "sym")
    assert a32 <= chip_smoke.F32_AMP_REL * s, a32
    assert e32 <= chip_smoke.F32_EP_ABS, e32
    assert a64 <= chip_smoke.F64_AMP_REL * s, a64
    assert e64 <= chip_smoke.F64_EP_ABS, e64


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir_rule(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and setup_jax sets
    no other; unset, the cache is <repo>/.jax_cache exactly."""
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax, ecw_cc_tpu.ops, ecw_cc_tpu.config as c; "
            "c.setup_jax(); print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want


def test_run_solver_records_each_lambda():
    """build_ecw + run_solver (what run_spec composes, and what the smoke's
    flagship phase calls) keep one convergence text, iteration count and
    Delta per lambda on the driver."""
    from ecw_cc_tpu.__main__ import build_ecw, run_solver

    spec = {"molecule": "h2", "basis": "sto-3g",
            "target": {"prop": "mat", "posthf": "HF",
                       "field": [0.02, 0.0, 0.0]},
            "run": {"solver": "CCSD_GS", "Larray": [0.0, 0.2, 3],
                    "conv_thres": 1e-7, "maxiter": 50}}
    ecw = build_ecw(spec)
    res = run_solver(ecw, spec["run"])
    assert len(ecw.conv_lamb) == len(ecw.iters_lamb) == 3
    assert all(t.startswith("Convergence reached") for t in ecw.conv_lamb)
    assert all(n >= 1 for n in ecw.iters_lamb)
    assert ecw.iters_lamb[-1] == len(res[1])
    assert len(ecw.Delta_lamb) == 3 and np.all(np.isfinite(ecw.Delta_lamb))
