"""__graft_entry__ in a FRESH process WITHOUT tests/conftest.py's CPU pinning.

dryrun_multichip must pin the CPU backend itself: it builds its mesh from
virtual CPU devices and must run the same whether or not an accelerator is
present.  The subprocess below inherits the environment minus conftest's
platform and dtype settings.
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _driver_env():
    """The caller's environment without conftest's platform pinning and
    dtype overrides (the compile-cache opt-out stays: CPU programs)."""
    env = os.environ.copy()
    for k in ("ECW_CC_TPU_X64", "ECW_CC_TPU_DTYPE", "ECW_CC_TPU_ITERPREC",
              "XLA_FLAGS", "JAX_PLATFORMS"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_dryrun_multichip_fresh_subprocess():
    """dryrun_multichip(8) must go green with no conftest help — and must
    keep every buffer on the CPU even when an accelerator is present."""
    code = ("import __graft_entry__ as g; g.dryrun_multichip(8); "
            "print('SUBPROCESS_DRYRUN_DONE')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_driver_env(), capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, (
        f"dryrun subprocess failed (rc={r.returncode}):\n"
        f"--- stdout ---\n{r.stdout[-2000:]}\n--- stderr ---\n{r.stderr[-4000:]}")
    assert "SUBPROCESS_DRYRUN_DONE" in r.stdout
    assert "cpu-only buffers" in r.stdout


def test_entry_shapes_and_step():
    """entry() returns a jittable step; run it once (conftest CPU backend)."""
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.pop(0)
    import jax

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    t1n, t2n, l1n, l2n, ep = out
    assert t1n.shape == args[0].shape
    assert t2n.shape == args[1].shape
    assert np.isfinite(float(ep))
