"""Test configuration: force CPU with a virtual 8-device mesh and x64.

All parity tests run in float64 on the CPU backend (the reference is float64
NumPy).  Sharding tests use the 8 virtual devices.

The suite keeps XLA:CPU programs out of the persistent compilation cache
(JAX_ENABLE_COMPILATION_CACHE=false, inherited by the subprocesses the tests
start): XLA:CPU cache entries hold machine code for the CPU that compiled
them, and loading one written on another host can crash with SIGILL.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("ECW_CC_TPU_X64", "1")
os.environ.setdefault("ECW_CC_TPU_DTYPE", "float64")
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

import ecw_cc_tpu.config as _cfg
from ecw_cc_tpu.models.molecule import Molecule


_LAST_MODULE = [None]


@pytest.fixture(autouse=True)
def _release_executables_between_modules(request):
    """XLA:CPU's JIT code loader can SIGSEGV once one process holds many
    loaded executables (observed 2026-08-21 on this host: three full-suite
    runs crashed deterministically at ~test 151 — inside
    backend_compile_and_load with the persistent cache off, inside the
    cache's AOT deserializer with it on — while the SAME program
    compiles+runs fine in a fresh process or any half-suite subset).
    jax.clear_caches() at module boundaries releases the accumulated
    LoadedExecutables; session fixtures hold only arrays, so the cost is
    re-compiling a handful of shared helper programs per module."""
    mod = request.module.__name__
    if _LAST_MODULE[0] not in (None, mod):
        jax.clear_caches()
    _LAST_MODULE[0] = mod
    yield


@pytest.fixture(autouse=True)
def _restore_global_config():
    """Tests that exercise the f32 production paths (entry module,
    precision modes, ladder modes) mutate the global Config and the jax
    x64/matmul flags; a leak flips later f64 parity tests into f32 (seen:
    test_graft_entry's in-process entry() disabling x64 for the whole
    suite).  Snapshot and restore around EVERY test."""
    import dataclasses

    snap = dataclasses.asdict(_cfg.get_config())
    x64 = jax.config.jax_enable_x64
    prec = jax.config.jax_default_matmul_precision
    yield
    _cfg.set_config(**snap)
    jax.config.update("jax_enable_x64", x64)
    jax.config.update("jax_default_matmul_precision", prec)
from ecw_cc_tpu.models.scf import RHF, GHF
from ecw_cc_tpu.models.eris import build_eris


@pytest.fixture(scope="session")
def h2_631g():
    """H2/6-31G system: mol, ghf, host eris, device eris (the reference's
    CCS self-test system, CCS.py:2605-2612)."""
    mol = Molecule("H 0 0 0\nH 0 0 1", "6-31g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    eris_host = build_eris(mol, ghf)
    return mol, ghf, eris_host, eris_host.to_device()


@pytest.fixture(scope="session")
def h2o_sto3g():
    mol = Molecule("h2o", "sto-3g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    eris_host = build_eris(mol, ghf)
    return mol, ghf, eris_host, eris_host.to_device()


@pytest.fixture(scope="session")
def h2o_631g():
    mol = Molecule("h2o", "6-31g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    eris_host = build_eris(mol, ghf)
    return mol, ghf, eris_host, eris_host.to_device()


# --- smoke subset ----------------------------------------------------------
# `pytest -m smoke` runs a fast (~2-4 min) broad-coverage slice: every
# subsystem's cheapest parity/oracle tests plus the reference's doctest
# anchors, for quick iteration between full-suite runs.  Whole modules below
# are smoke when listed in _SMOKE_MODULES; a few individually fast tests
# from the slow e2e modules are added by name in _SMOKE_TESTS.
_SMOKE_MODULES = {
    "test_ccs_kernels",
    "test_ccsd_kernels",
    "test_linalg_device",
    "test_spinsect_property",
    "test_props_tdscf",
    "test_es_eqs",
}
_SMOKE_TESTS = {
    # doctest anchors (EHF/Eexp/Ep digits, 8-iteration CCS convergence)
    "test_doctest_anchors",
    # one end-to-end regression per pillar
    "test_ccsd_L0_equals_plain_ccsd",
    "test_generated_ccsd_equals_factorized_at_random_amps",
    # sharded == replicated on the virtual mesh (cheapest parallel test)
    "test_sharded_ccsd_step_matches_replicated",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        name = item.name.split("[", 1)[0]
        if mod in _SMOKE_MODULES or name in _SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)


def random_g_amp(rng, nocc, nvir, scale=0.1):
    """Random amplitudes in R format converted to G [0,1,0,1,...] format
    (mirrors reference utilities.convert_r_to_g_amp for the 2-dim case)."""
    r = rng.random((nocc // 2, nvir // 2)) * scale
    g = np.zeros((nocc, nvir))
    g[0::2, 0::2] = r
    g[1::2, 1::2] = r
    return g
