"""Jacobian / Newton solver smoke test (counterpart of reference
test/Tram_test.py): builds the exact coupled (T1, Lambda1) Jacobian by
autodiff and takes Newton steps on H2O/STO-3G.

Run:  python examples/newton_smoke.py

Runs on the default JAX device (f64 parity mode unless ECW_CC_TPU_DTYPE=
float32); JAX_PLATFORMS=cpu selects the CPU.
"""

import numpy as np

from ecw_cc_tpu import ECW

ecw = ECW("h2o", "sto-3g")
ecw.Build_GS_exp("mat", "HF", field=[0.02, 0.01, 0.0])

res = ecw.CCS_GS([0.05], method="newton", conv_thres=1e-8, maxiter=20)
print("\nNewton converged:", res[0])
print("Ep per iteration:", np.round(res[1], 10))

# steepest descent: stability needs beta < 1/max(eia)^2 (~0.002 with the
# O 1s orbital in the window), same fragility as the reference method
res2 = ecw.CCS_GS([0.05], method="descend", beta=0.002, conv_thres=1e-6,
                  maxiter=500)
print("\nSteepest descent:", res2[0])
