"""Newton / Gradient-descent solver tests.

Ports the reference's own Jacobian/Newton convergence checks
(/root/reference/ECW_CC/CCS.py:2744-2801, exercised by its __main__) to
pytest: quadratic residual decay, Newton fixed point == SCF fixed point at
the same L, the autodiff Jacobian vs central finite differences (including
the device-Vexp property-model path, ops/ccs.py ccs_gradient(Vexp_model=2)),
and descent-direction correctness of Gradient_Descent.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ecw_cc_tpu import ECW
from ecw_cc_tpu.ops import ccs as ccs_ops
from ecw_cc_tpu.ops.ccs import ccs_gradient
from ecw_cc_tpu.ops.vexp import Exp


@pytest.fixture(scope="module")
def h2_setup():
    ecw = ECW("h2", "6-31g")
    ecw.Build_GS_exp("mat", "HF", field=[0.03, 0.0, 0.0])
    return ecw


def _grad_and_state(ecw, L, seed=7, scale=0.01, model=1):
    eris = ecw._eris_alt()
    VXexp = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    grad = ccs_gradient(eris, Vexp_model=model,
                        exp_pot=VXexp if model in (2, 3) else None)
    rng = np.random.default_rng(seed)
    no, nv = eris.nocc, eris.nvir
    ts = jnp.asarray(scale * rng.standard_normal((no, nv)))
    ls = jnp.asarray(scale * rng.standard_normal((no, nv)))
    # a consistent fsp0 at the linearization point
    rdm1 = ccs_ops.gamma_CCS(ts, ls)
    VXexp.Vexp_update(np.asarray(rdm1), np.asarray(rdm1), (0, 0), L=L)
    fsp = jnp.asarray(eris.fock - jnp.asarray(np.asarray(VXexp.Vexp[0, 0],
                                                         dtype=float)))
    return eris, grad, ts, ls, fsp


@pytest.mark.parametrize("model", [1, 2])
def test_jacobian_vs_finite_difference(h2_setup, model):
    """The jacfwd Jacobian of the coupled (T1, L1) residuals — including
    the fsp(t, l) dependence through Vexp(gamma) — equals central finite
    differences (model 1: local 'mat'-linear closure; model 2: the device
    Vexp property model, ops/ccs.py:766-777)."""
    ecw = h2_setup
    L = 0.1
    eris, grad, ts, ls, fsp = _grad_and_state(ecw, L, model=model)
    J, R0 = grad.Jacobian(ts, ls, fsp, L)
    J = np.asarray(J)
    n = ts.size

    gamma0 = ccs_ops.gamma_CCS(ts, ls)
    x0 = np.concatenate([np.asarray(ts).ravel(), np.asarray(ls).ravel()])

    def stacked(x):
        t = jnp.asarray(x[:n].reshape(ts.shape))
        l = jnp.asarray(x[n:].reshape(ls.shape))
        T1, L1 = grad._residuals(t, l, fsp, gamma0, L)
        return np.concatenate([np.asarray(T1).ravel(),
                               np.asarray(L1).ravel()])

    h = 1e-6
    J_fd = np.zeros_like(J)
    for j in range(2 * n):
        e = np.zeros(2 * n)
        e[j] = h
        J_fd[:, j] = (stacked(x0 + e) - stacked(x0 - e)) / (2 * h)
    assert np.max(np.abs(J - J_fd)) < 5e-7


def test_newton_quadratic_decay(h2_setup):
    """|R| along the Newton iteration decays quadratically: starting from a
    perturbed point, the residual ratio |R_{k+1}|/|R_k|^2 stays bounded
    while |R| runs down to solver precision (reference CCS.py:2744-2801
    convergence check, strengthened)."""
    ecw = h2_setup
    L = 0.1
    eris, grad, ts, ls, fsp = _grad_and_state(ecw, L, scale=0.02)
    VXexp = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    norms = []
    for _ in range(8):
        # refresh fsp from Vexp at the current rdm1, exactly as the solver
        # loop does (solvers/gs.py Gradient): the residual function is then
        # stationary and the iteration is a true Newton
        rdm1 = np.asarray(ccs_ops.gamma_CCS(ts, ls))
        VXexp.Vexp_update(rdm1, rdm1, (0, 0), L=L)
        fsp = jnp.asarray(eris.fock
                          - jnp.asarray(np.asarray(VXexp.Vexp[0, 0],
                                                   dtype=float)))
        _, R = grad.Jacobian(ts, ls, fsp, L)
        norms.append(float(jnp.linalg.norm(R)))
        ts, ls = grad.Newton(ts, ls, fsp, L)
    # converged well below the fixed-step floor
    assert norms[-1] < 1e-10
    # quadratic (at least superlinear) contraction on the way down:
    # every step from 1e-2 scale must at least square-and-scale the norm
    for a, b in zip(norms[2:6], norms[3:7]):
        if a > 1e-13:
            assert b < max(50.0 * a * a, 1e-14)


def test_newton_fixed_point_matches_scf(h2_setup):
    """Newton and SCF converge to the same (Ep, rdm1) at the same L
    (reference CCS.py __main__ cross-check)."""
    ecw = h2_setup
    r_scf = ecw.CCS_GS([0.1], method="scf", conv_thres=1e-10, maxiter=200)
    r_newton = ecw.CCS_GS([0.1], method="newton", conv_thres=1e-10,
                          maxiter=30)
    assert "onverg" in r_newton[0]
    assert abs(r_newton[1][-1] - r_scf[1][-1]) < 1e-8
    assert np.max(np.abs(np.asarray(r_newton[4]) - np.asarray(r_scf[4]))) \
        < 1e-6
    # Newton never needs more iterations than the plain SCF map
    assert len(r_newton[1]) <= len(r_scf[1])


def test_gradient_descent_decreases_residual(h2_setup):
    """Gradient_Descent is a descent method on 1/2 |R|^2: small steps
    monotonically shrink the residual from a perturbed start (reference
    CCS.py:2126-2160)."""
    ecw = h2_setup
    L = 0.1
    eris, grad, ts, ls, fsp = _grad_and_state(ecw, L, scale=0.02, seed=3)

    def rnorm(t, l):
        _, R = grad.Jacobian(t, l, fsp, L)
        return float(jnp.linalg.norm(R))

    r_prev = rnorm(ts, ls)
    for _ in range(5):
        ts, ls = grad.Gradient_Descent(0.05, ts, ls, fsp, L)
        r = rnorm(ts, ls)
        assert r < r_prev
        r_prev = r
