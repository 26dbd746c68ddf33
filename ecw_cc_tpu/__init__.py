"""
ecw_cc_tpu — a JAX framework for Experimentally Constrained Wave function
Coupled Cluster (ECW-CC), built from scratch on JAX/XLA.

Capabilities (parity target: MilaimKas/ECW_CC, see SURVEY.md):
  - Ground-state ECW-CCS and ECW-CCSD with SCF+DIIS solvers, L1 regularization
    and lambda(weight)-sweeps  (reference: Solver_GS.py, CCS.py, CCSD.py)
  - Excited-state ECW-CCS: coupled multi-state R/L/r0/l0 solve with state and
    transition constraint potentials  (reference: Solver_ES.py)
  - Vexp constraint engine over target rdm1s and one-electron properties
    (Ek, v1e, dip, trdip, DEk, structure factors)  (reference: exp_pot.py)
  - Simulated target generation: HF/CCSD/CCSD(T) + static field + geometry
    deformation + underfitting; MOM excited-state targets (reference: gamma_exp.py)
  - A standalone host-side quantum-chemistry front end (Gaussian integrals,
    RHF/UHF SCF, GHF conversion) replacing the reference's PySCF dependency.

Architecture: the host layer (molecule/basis/integrals/SCF) runs in NumPy; all
CC residual updates, rdm1 builds and the Vexp coupling run on-device (a GPU in
production) as jitted einsum/dot_general contractions. Solvers run as
lax.while_loop fixed-point iterations with on-device DIIS.

Usage mirrors the reference (`__init__.py:9-40` doctest of the reference):

    from ecw_cc_tpu import ECW
    ecw = ECW('h2o', '6-31g')
    ecw.Build_GS_exp('mat', 'HF', field=[0.05, 0.01, 0.0])
    result = ecw.CCS_GS([0.5])
"""

__version__ = "0.1.0"

from ecw_cc_tpu.config import Config, get_config, set_config  # noqa: F401


def __getattr__(name):
    # Lazy import of the heavy driver to keep `import ecw_cc_tpu` fast.
    if name == "ECW":
        from ecw_cc_tpu.models.ecw import ECW
        return ECW
    raise AttributeError(f"module 'ecw_cc_tpu' has no attribute {name!r}")
