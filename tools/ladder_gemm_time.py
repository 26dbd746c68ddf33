"""Time the vvvv ladder GEMMs on the GPU at production shapes.

  dense   the dense-route ladder, ops/ladder._ladder_mm_xla, at the
          C2H2/cc-pVDZ shape (o^2 x v^2) . (v^2 x v^2) = 196x3844 . 3844x3844
  sector  the production ladder of one C2H2/cc-pVTZ iteration:
          ladder.balanced_stacked_sectored_contract on the real SectoredVVVV
          operand (t and lambda ladders stacked, closed-shell mirror mode)

each at matmul precision 'highest' (true FP32) and 'high' (TF32 on the
tensor cores), as the median over windows of back-to-back calls ended by
block_until_ready.  FLOPs: 2*M*N*K for the dense GEMM, XLA's cost analysis
of the call compiled for the CPU for the sectored one.  Shares are against the H100
SXM data-sheet peaks (67 TFLOP/s FP32, 495 TFLOP/s dense TF32).

Run:  python tools/ladder_gemm_time.py       (GPU only)
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_TFLOPS = {"highest": 67.0, "high": 495.0}   # H100 SXM data sheet


def _time(f, args, reps=20, windows=5):
    import jax

    jax.block_until_ready(f(*args))            # compile + warm
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / reps)
    return float(np.median(per))


def _flops(fn, args):
    """XLA cost-model FLOPs of fn, compiled for the CPU: the GPU cost
    analysis leaves out the GEMMs it hands to cuBLAS."""
    import jax

    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          args)
    cost = jax.jit(fn, backend="cpu").lower(*shapes).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"GPU only; the default device is {dev.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    import ecw_cc_tpu.config as config

    config.set_config(x64=False, dtype="float32")
    config.setup_jax()
    from ecw_cc_tpu.models.gamma_exp import _build_eris_sorted
    from ecw_cc_tpu.models.molecule import Molecule
    from ecw_cc_tpu.models.scf import GHF, RHF
    from ecw_cc_tpu.ops import ladder
    from ecw_cc_tpu.ops.ccsd_sect import _tau_b
    from ecw_cc_tpu.ops.spinsect import wrap

    rows = []
    # dense pVDZ shape
    o, v = 14, 62
    rng = np.random.default_rng(0)
    tau = jnp.asarray(rng.standard_normal((o * o, v * v)), jnp.float32)
    vv = jnp.asarray(rng.standard_normal((v * v, v * v)), jnp.float32)
    flops = 2.0 * (o * o) * (v * v) * (v * v)
    for prec in ("highest", "high"):
        with jax.default_matmul_precision(prec):
            f = jax.jit(lambda a, b: ladder._ladder_mm_xla(a, b))
            t = _time(f, (tau, vv))
        rows.append({"gemm": "dense_pvdz", "shape": [o * o, v * v, v * v],
                     "precision": prec, "ms": t * 1e3, "gflop": flops / 1e9,
                     "tflops": flops / t / 1e12,
                     "peak_share": flops / t / 1e12 / PEAK_TFLOPS[prec]})
        print(json.dumps(rows[-1]), flush=True)

    # sectored pVTZ production ladder
    mol = Molecule("c2h2", "cc-pvtz")
    mf = RHF(mol)
    mf.kernel()
    eris, sect, (info, sym), _ = _build_eris_sorted(mol, GHF(mf))
    d = jnp.diag(eris.fock)
    eia = d[:eris.nocc, None] - d[None, eris.nocc:]
    t2 = eris.oovv / (eia[:, None, :, None] + eia[None, :, None, :])
    t1 = jnp.zeros_like(eia)

    def lad(sect, t1, t2):
        tau_b = _tau_b(wrap(t2, "oovv", info, sym=sym),
                       wrap(t1, "ov", info, sym=sym))
        out = ladder.balanced_stacked_sectored_contract(
            sect, tau_b, t2, info.oa, sym=sym, blocked_info=info)
        return [dict(r.blocks) for r in out]       # SpinBlocked -> arrays

    for prec in ("highest", "high"):
        with jax.default_matmul_precision(prec):
            f = jax.jit(lad)
            fl = _flops(lad, (sect, t1, t2))
            t = _time(f, (sect, t1, t2))
        rows.append({"gemm": "sector_pvtz", "sym": bool(sym),
                     "precision": prec, "ms": t * 1e3, "gflop": fl / 1e9,
                     "tflops": fl / t / 1e12,
                     "peak_share": fl / t / 1e12 / PEAK_TFLOPS[prec]})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "device": dev.device_kind, "rows": rows}))


if __name__ == "__main__":
    main()
