"""Measure the REAL pVTZ NumPy-baseline full step (reference engine:
NumPy/BLAS dense contractions, SURVEY.md section 6) and cache it in
.bench_baseline.json under bench.py's STEP_VERSION key, replacing the
FLOP-scaled estimate.

~15 min/iteration on one core; run offline (no accelerator is involved):

    PYTHONPATH=/root/repo:$PYTHONPATH python tools/measure_numpy_baseline.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main(basis="cc-pvtz", n_timed=1):
    import bench
    from ecw_cc_tpu.models.eris import GEris, build_eris_device
    import ecw_cc_tpu.config as config

    config.set_config(x64=False, dtype="float32")
    mol, ghf = bench.build_host(basis)
    print(f"building dense {basis} eris on cpu ...", flush=True)
    eris = build_eris_device(mol, ghf, dtype="float32")
    blocks = {f: np.asarray(getattr(eris, f), dtype=np.float64)
              for f in GEris._fields}
    del eris
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    amps = bench.mp2_amps(blocks)
    print("warm-up step ...", flush=True)
    t0 = time.perf_counter()
    bench.numpy_full_step(blocks, *amps, target, bench.LW)
    warm = (time.perf_counter() - t0) * 1e3
    print(f"warm-up: {warm / 1e3:.1f} s", flush=True)
    times = [warm]
    for i in range(n_timed):
        t0 = time.perf_counter()
        bench.numpy_full_step(blocks, *amps, target, bench.LW)
        times.append((time.perf_counter() - t0) * 1e3)
        print(f"timed {i}: {times[-1] / 1e3:.1f} s", flush=True)
    numpy_ms = min(times)

    # keyed on the CPU identity: the baseline is a host timing
    key = f"{basis}_v{bench.STEP_VERSION}_{bench._cpu_host_key()}"
    cache = {}
    if os.path.exists(bench.BASE_FILE):
        with open(bench.BASE_FILE) as f:
            cache = json.load(f)
    cache[key] = numpy_ms
    tmp = bench.BASE_FILE + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f)
    os.replace(tmp, bench.BASE_FILE)
    print(f"cached {key} = {numpy_ms:.1f} ms in {bench.BASE_FILE}")


if __name__ == "__main__":
    main()
