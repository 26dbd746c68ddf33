"""GS ECW-CCSD lambda sweep on C2H2 (counterpart of reference
test/Test_ECW_GS.py: C2H2/6-31+g** CCSD sweep against a CCSD(T) 'mat'
target, cube files + result table).

Run:  python examples/gs_ccsd_sweep.py [basis] [out_dir]

Runs on the default JAX device (f64 parity mode unless ECW_CC_TPU_DTYPE=
float32); JAX_PLATFORMS=cpu selects the CPU.
"""

import sys

import numpy as np

from ecw_cc_tpu import ECW

basis = sys.argv[1] if len(sys.argv) > 1 else "6-31+g**"
out_dir = sys.argv[2] if len(sys.argv) > 2 else "c2h2_results"

# lambda array: 0 -> 0.7, 8 points (reference Test_ECW_GS.py:8-12)
Larray = np.linspace(0, 0.7, 8)

ecw = ECW("c2h2", basis, out_dir=out_dir)

# target = CCSD(T) rdm1 (reference uses 'CCSDt')
ecw.Build_GS_exp("mat", "CCSD(T)")

results = ecw.CCSD_GS(Larray, print_ite_info=True, conv_thres=1e-6,
                      maxiter=80, diis="tl",
                      checkpoint_dir=out_dir + "/ckpt")
ecw.print_results()
ecw.plot_results().savefig(out_dir + "/sweep.png", dpi=150)
print(f"results written to {out_dir}/")
