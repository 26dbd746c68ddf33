"""XLA cost-model table: FLOPs + bytes accessed per production iteration.

Chip-independent evidence for the round-3 kernel work: compiles the REAL
production step (bench.device_full_step — the body of
Solver_CCSD.SCF_device) for CPU at C2H2 pVDZ/pVTZ shapes in the three
kernel routes and reports the XLA cost model's flops / bytes-accessed.
Bytes are the HBM-traffic proxy (the step is bandwidth-bound); flops are
backend-independent.

Run:  python tools/cost_table_r3.py [pvdz|pvtz|both]
"""

import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")

import ecw_cc_tpu.config as config

config.set_config(x64=False, dtype="float32")
config.setup_jax()

import numpy as np          # noqa: E402
import jax.numpy as jnp     # noqa: E402

import bench                # noqa: E402
from ecw_cc_tpu.models.eris import GEris, build_eris_device  # noqa: E402
from ecw_cc_tpu.ops.ladder import spin_sort_perm             # noqa: E402
from ecw_cc_tpu.ops.spinsect import sector_info              # noqa: E402


def cost(step, eris_shapes, arg_shapes):
    lowered = jax.jit(step, backend="cpu").lower(eris_shapes, *arg_shapes)
    c = lowered.compile().cost_analysis()
    if isinstance(c, (list, tuple)):
        c = c[0]
    return float(c.get("flops", float("nan"))), float(
        c.get("bytes accessed", float("nan")))


def table(basis):
    mol, ghf = bench.build_host(basis)
    nocc = int(np.sum(ghf.mo_occ > 0))
    rows = {}
    for name, flags in (
            ("dense", dict(spin_sorted=False, soup_sector=False,
                           soup_sym=False)),
            ("sectored", dict(spin_sorted=True, soup_sector=True,
                              soup_sym=False)),
            ("sectored+sym", dict(spin_sorted=True, soup_sector=True,
                                  soup_sym=True))):
        config.set_config(**flags)
        sort = flags["spin_sorted"]
        eris, vvvv_op = build_eris_device(mol, ghf, dtype="float32",
                                          pack_ladder=True, sort_spin=sort)
        dtype = jnp.float32
        nmo = eris.fock.shape[0]
        nvir = nmo - nocc
        target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
        if sort:
            perm = spin_sort_perm(ghf.orbspin, nocc)
            target = target[np.ix_(perm, perm)]
            info = sector_info(ghf.orbspin, nocc)
            sym = flags["soup_sym"]
        else:
            info, sym = None, False
        step = bench.device_full_step(target.astype(np.float32),
                                      np.float32(bench.LW),
                                      sect_info=info, sym=sym)
        sect_shapes = (None if vvvv_op is None else jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, dtype), vvvv_op))
        eris_shapes = GEris(**{
            f: jax.ShapeDtypeStruct(getattr(eris, f).shape, dtype)
            for f in GEris._fields})
        amp_shapes = [
            jax.ShapeDtypeStruct((nocc, nvir), dtype),
            jax.ShapeDtypeStruct((nocc, nocc, nvir, nvir), dtype),
            jax.ShapeDtypeStruct((nocc, nvir), dtype),
            jax.ShapeDtypeStruct((nocc, nocc, nvir, nvir), dtype)]
        fl, by = cost(step, eris_shapes, (sect_shapes,) + tuple(amp_shapes))
        rows[name] = {"gflops": round(fl / 1e9, 2),
                      "gbytes": round(by / 1e9, 3)}
        print(f"{basis:8s} {name:14s} {rows[name]['gflops']:8.2f} GF  "
              f"{rows[name]['gbytes']:8.3f} GB", flush=True)
    d = rows.get("dense", {})
    s = rows.get("sectored+sym", {})
    if d and s:
        print(f"{basis:8s} cuts: flops x{d['gflops']/s['gflops']:.2f}  "
              f"bytes x{d['gbytes']/s['gbytes']:.2f}", flush=True)
    return rows


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    out = {}
    if which in ("pvdz", "both"):
        out["cc-pvdz"] = table("cc-pvdz")
    if which in ("pvtz", "both"):
        out["cc-pvtz"] = table("cc-pvtz")
    print(json.dumps(out))
