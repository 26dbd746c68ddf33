"""2-D scan of the ECW-CCS cost landscape on H2/STO-3G with solver
trajectories overlaid (counterpart of reference test/Plot_TL.py): the
(t1[0,0], l1[0,0]) plane is scanned on a grid — here as a single vmapped
device computation instead of a double Python loop — and the SCF solver's
trajectory is plotted on top.

Run:  python examples/landscape_scan.py [out.png]

Runs on the default JAX device (f64 parity mode unless ECW_CC_TPU_DTYPE=
float32); JAX_PLATFORMS=cpu selects the CPU.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp

from ecw_cc_tpu import ECW
from ecw_cc_tpu.ops import ccs as ccs_ops
from ecw_cc_tpu.ops.ccs import Gccs
from ecw_cc_tpu.ops.vexp import Exp
from ecw_cc_tpu.solvers.gs import Solver_CCS

out = sys.argv[1] if len(sys.argv) > 1 else "landscape.png"

ecw = ECW("h2", "sto-3g")
ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.0, 0.0])
L = 0.3
target = jnp.asarray(ecw.exp_data[0][0][1])
eris = ecw.eris
fock = jnp.asarray(ecw.fock)

# residual-norm landscape over the (t[0,0], l[0,0]) plane, vmapped
def cost(t00, l00):
    ts = jnp.zeros((ecw.nocc, ecw.nvir)).at[0, 0].set(t00)
    ls = jnp.zeros((ecw.nocc, ecw.nvir)).at[0, 0].set(l00)
    rdm1 = ccs_ops.gamma_CCS(ts, ls)
    fsp = fock - L * (target - rdm1)
    T1 = ccs_ops.T1eq(eris, ts, fsp)
    L1 = ccs_ops.L1eq(eris, ts, ls, fsp)
    return jnp.sum(T1 ** 2) + jnp.sum(L1 ** 2)

grid = jnp.linspace(-0.6, 0.6, 81)
Z = jax.jit(jax.vmap(jax.vmap(cost, (None, 0)), (0, None)))(grid, grid)

# SCF trajectory
VX = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
solver = Solver_CCS(Gccs(eris), VX, conv="tl", conv_thres=1e-8, maxiter=60)
r = solver._scf_host(L, store_ite=True)
traj_t = [ts[0, 0] for ts in r[5]]
traj_l = [ls[0, 0] for ls in r[6]]

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, ax = plt.subplots(figsize=(6, 5))
cs = ax.contourf(np.asarray(grid), np.asarray(grid),
                 np.log10(np.asarray(Z).T + 1e-12), levels=30, cmap="viridis")
fig.colorbar(cs, label="log10 |residual|^2")
ax.plot(traj_t, traj_l, "r.-", label="SCF trajectory")
ax.set_xlabel("t1[0,0]")
ax.set_ylabel("l1[0,0]")
ax.legend()
fig.savefig(out, dpi=150)
print("wrote", out)
