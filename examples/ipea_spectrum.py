"""EOM-IP/EA-CCSD ionization + attachment spectrum of H2O/6-31G.

A capability beyond the reference (its EOM machinery is an EE-only stub,
gamma_exp.py:464-470, and it has no IP/EA ladder): sigma equations derived
by the in-house Wick engine (ops/wick.generate_eom_terms), Davidson with
Koopman guesses, left eigenvectors on request.

Run:  python examples/ipea_spectrum.py
"""

import numpy as np

from ecw_cc_tpu.models.molecule import Molecule
from ecw_cc_tpu.models.scf import RHF, GHF
from ecw_cc_tpu.models.eris import build_eris
from ecw_cc_tpu.ops.ccsd_t import solve_ccsd
from ecw_cc_tpu.ops.eom_ipea import eom_ea_ccsd, eom_ip_ccsd

EV = 27.211386

mol = Molecule("h2o", "6-31g")
mf = RHF(mol)
mf.kernel()
ghf = GHF(mf)
eris = build_eris(mol, ghf).to_device()

t1, t2, ecc = solve_ccsd(eris, conv_tol=1e-10)
print(f"CCSD correlation energy: {ecc:.8f} au")

mo_e = np.diag(np.asarray(eris.fock))
nocc = eris.nocc

print("\nEOM-IP-CCSD ionization energies (valence):")
omegas, Rs, Ls = eom_ip_ccsd(eris, t1, t2, nroots=4, tol=1e-7, left=True)
from ecw_cc_tpu.models.gamma_exp import solve_lambda
from ecw_cc_tpu.ops.eom_ipea import dyson_orbitals
from ecw_cc_tpu.utils.output import cube_orbital_g

lam1, lam2 = solve_lambda(eris, t1, t2, conv_tol=1e-10)
dys = dyson_orbitals(t1, t2, Rs, Ls, "ip", lam1=lam1, lam2=lam2)
for k, (w, (r1, r2), (dL, dR, s)) in enumerate(zip(omegas, Rs, dys)):
    # Koopmans comparison: the orbital the 1h weight sits on
    i = int(np.argmax(np.abs(r1)))
    print(f"  root {k}: {w * EV:8.3f} eV   (Koopmans {-mo_e[i] * EV:8.3f} eV,"
          f" 1h weight {np.linalg.norm(r1) ** 2:.3f},"
          f" pole strength {s:.3f})")
# Dyson orbital of the lowest IP as a cube file (VMD-renderable, like the
# reference's Figures/ workflow)
cube_orbital_g(dys[0][0], ghf.mo_coeff, mol, "/tmp/dyson_ip0.cube",
               nx=40, ny=40, nz=40)
print("  Dyson orbital of root 0 written to /tmp/dyson_ip0.cube")

print("\nEOM-EA-CCSD attachment energies:")
omegas, Rs = eom_ea_ccsd(eris, t1, t2, nroots=2, tol=1e-7)
for k, (w, (r1, r2)) in enumerate(zip(omegas, Rs)):
    a = int(np.argmax(np.abs(r1)))
    print(f"  root {k}: {w * EV:8.3f} eV   (Koopmans "
          f"{mo_e[nocc + a] * EV:8.3f} eV, 1p weight "
          f"{np.linalg.norm(r1) ** 2:.3f})")
