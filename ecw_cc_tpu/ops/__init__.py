"""Device ops: jitted CC kernels (CCS/CCSD), raw-equation oracles, Vexp engine,
DIIS, L1 regularization."""

from ecw_cc_tpu.config import setup_jax

setup_jax()
