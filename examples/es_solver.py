"""Excited-state ECW-CCS on H2O with QChem transition-dipole targets
(counterpart of reference test/Test_ECW_ES.py: H2O/6-31++g** ES solve,
lambda loop over 15 points).

Run:  python examples/es_solver.py

Runs on the default JAX device (f64 parity mode unless ECW_CC_TPU_DTYPE=
float32); JAX_PLATFORMS=cpu selects the CPU.
"""

import numpy as np

from ecw_cc_tpu import ECW

ecw = ECW("h2o", "6-31++g**")

# QChem H2O EOM-CCSD references (reference gamma_exp.py:27-94):
#   ES1: 7.6051 eV, tr dip y = (0.523742+0.550251)/2
#   ES2: 9.9605 eV, tr dip z = (0.622534+0.649058)/2
dip1 = (0.523742 + 0.550251) / 2.0
dip2 = (0.622534 + 0.649058) / 2.0
es_prop = [[["trdip", (dip1, 0.0, 0.0)]], [["trdip", (0.0, 0.0, dip2)]]]
ecw.Build_ES_exp_input(es_prop)

# lambda loop 0 -> 0.1 (reference Test_ECW_ES.py:41-44)
Larray = np.linspace(0, 0.1, 15)
ecw.CCS_ES(Larray, L_loop=True, diis="all", conv="rl", conv_thres=1e-5,
           maxiter=80, print_ite=False)
ecw.print_results_ES()
