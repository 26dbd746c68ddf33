"""Device small-eig + fused Davidson vs host references.

The fused Davidson (utils/linalg.davidson_fused_device) replaces the
host-cycle davidson_nosym_device for the whole EOM surface; these tests pin
eigensolver accuracy against numpy.linalg.eig and root parity against the
host Davidson (the analogue of pyscf lib.davidson_nosym1,
/root/reference/ECW_CC/Solver_ES.py:710-711).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ecw_cc_tpu.utils import linalg
from ecw_cc_tpu.utils.schur import eig_small


def _match_err(wref, wgot):
    wref = list(wref)
    err = 0.0
    for w in wgot:
        i = int(np.argmin([abs(w - x) for x in wref]))
        err = max(err, abs(w - wref.pop(i)))
    return err


@pytest.mark.parametrize("case", ["random", "imag_pairs", "diag_dom",
                                  "degenerate", "padded"])
def test_eig_small_vs_numpy(case):
    rng = np.random.default_rng(0)
    S = 20
    if case == "random":
        H = rng.standard_normal((S, S))
    elif case == "imag_pairs":
        A = rng.standard_normal((S, S))
        H = A - A.T + 0.1 * np.diag(rng.standard_normal(S))
    elif case == "diag_dom":
        H = np.diag(np.linspace(0.5, 3.0, S)) + 0.05 * rng.standard_normal((S, S))
    elif case == "degenerate":
        H = (np.diag([1.0, 1.0] + list(np.linspace(2, 5, S - 2)))
             + 0.01 * rng.standard_normal((S, S)))
    else:  # padded: active 7x7 block + big distinct diagonal (the Davidson
        # projected-matrix masking pattern)
        H = np.zeros((S, S))
        H[:7, :7] = np.diag(np.linspace(0.5, 2.0, 7)) \
            + 0.05 * rng.standard_normal((7, 7))
        H += np.diag([0.0] * 7 + [1e3 * (2 + i) for i in range(S - 7)])
    lam, X = jax.jit(eig_small)(jnp.asarray(H))
    lam = np.asarray(lam)
    X = np.asarray(X)
    res = np.linalg.norm(H @ X - X * lam[None, :], axis=0)
    assert res.max() < 1e-8 * max(1.0, np.abs(H).max())
    assert _match_err(np.linalg.eigvals(H), lam) < 1e-9 * max(
        1.0, np.abs(lam).max())


def _test_matrix(n=120, seed=3):
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1.0, n + 1.0)) + 0.05 * rng.standard_normal((n, n))
    return A


VARIANTS = {"fused": "davidson_fused_device",
            "pipelined": "davidson_pipelined_device"}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("nroots", [1, 3])
def test_fused_davidson_matches_host(nroots, variant):
    A = _test_matrix()
    n = A.shape[0]
    diag = np.diag(A)
    x0 = [np.eye(n)[k] for k in range(nroots)]
    ops = jnp.asarray(A)

    def mv(v, ops):
        return ops @ v

    conv_h, w_h, xs_h = linalg.davidson_nosym(
        lambda v: A @ v, x0, diag, nroots=nroots, tol=1e-9)
    conv_f, w_f, xs_f = getattr(linalg, VARIANTS[variant])(
        mv, x0, diag, nroots=nroots, tol=1e-9, operands=ops)
    assert all(conv_h[:nroots]) and all(conv_f[:nroots])
    assert np.allclose(w_f[:nroots], w_h[:nroots], atol=1e-8)
    for k in range(nroots):
        xf = np.asarray(xs_f[k])
        xh = np.asarray(xs_h[k])
        assert abs(abs(np.dot(xf, xh)) - 1.0) < 1e-6


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_davidson_follow_mode(variant):
    """Root homing: seed on the 5th-lowest diagonal; follow=True must stay
    on that root instead of falling to the ground state."""
    A = _test_matrix(seed=5)
    n = A.shape[0]
    diag = np.diag(A)
    x0 = [np.eye(n)[4]]
    ops = jnp.asarray(A)

    def mv(v, ops):
        return ops @ v

    solver = getattr(linalg, VARIANTS[variant])
    conv, w, xs = solver(
        mv, x0, diag, nroots=1, tol=1e-9, follow=True, operands=ops)
    w_all = np.sort(np.linalg.eigvals(A).real)
    assert conv[0]
    assert abs(w[0] - w_all[4]) < 1e-7
    # and WITHOUT follow it finds the lowest
    conv2, w2, _ = solver(
        mv, x0, diag, nroots=1, tol=1e-9, follow=False, operands=ops)
    assert conv2[0] and abs(w2[0] - w_all[0]) < 1e-7


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_davidson_restart(variant):
    """max_space smaller than the cycles needed forces the collapse path."""
    A = _test_matrix(seed=7)
    n = A.shape[0]
    diag = np.diag(A)
    ops = jnp.asarray(A)

    def mv(v, ops):
        return ops @ v

    conv, w, xs = getattr(linalg, VARIANTS[variant])(
        mv, [np.eye(n)[0]], diag, nroots=1, tol=1e-9, max_space=5,
        operands=ops)
    w_all = np.sort(np.linalg.eigvals(A).real)
    assert conv[0] and abs(w[0] - w_all[0]) < 1e-7


def test_pipelined_program_cache_reused():
    """Regression for the r4 retracing bug: repeated pipelined solves with
    a STABLE matvec must reuse the cached device programs (one _PL_PROGRAMS
    entry, same jitted objects), and the EOM/ES matvec factories must
    return identical objects across calls so the cache can hit."""
    A = _test_matrix(seed=11)
    n = A.shape[0]
    diag = np.diag(A)
    ops = jnp.asarray(A)

    def mv(v, ops):
        return ops @ v

    before = dict(linalg._PL_PROGRAMS)
    linalg.davidson_pipelined_device(mv, [np.eye(n)[0]], diag, nroots=1,
                                     tol=1e-9, operands=ops)
    added = {k: v for k, v in linalg._PL_PROGRAMS.items() if k not in before}
    assert len(added) == 1
    linalg.davidson_pipelined_device(mv, [np.eye(n)[1]], diag, nroots=1,
                                     tol=1e-9, operands=ops)
    added2 = {k: v for k, v in linalg._PL_PROGRAMS.items()
              if k not in before}
    assert added2 == added  # same single entry, same program objects

    # the call-site factories are lru_cached -> stable identities
    from ecw_cc_tpu.ops import eom, eom_ipea
    from ecw_cc_tpu.solvers import es
    assert eom._mv_factory(6, 10, None) is eom._mv_factory(6, 10, None)
    assert (eom_ipea._mv_factory("ip", False, 6, 10)
            is eom_ipea._mv_factory("ip", False, 6, 10))
    assert es._diag_matvecs(6, 10) is es._diag_matvecs(6, 10)


def test_pipelined_program_cache_bounded():
    """A churning caller (fresh matvec closure per solve) must evict + warn
    instead of leaking compiled programs forever."""
    import warnings

    A = _test_matrix(seed=13)
    n = A.shape[0]
    diag = np.diag(A)
    ops = jnp.asarray(A)
    x0 = [np.eye(n)[0]]

    saved = dict(linalg._PL_PROGRAMS)
    saved_warn = linalg._PL_WARNED[0]
    try:
        linalg._PL_PROGRAMS.clear()
        linalg._PL_WARNED[0] = False
        old_max = linalg._PL_PROGRAMS_MAX
        linalg._PL_PROGRAMS_MAX = 4
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(6):
                def mv(v, ops):          # fresh identity every iteration
                    return ops @ v
                linalg.davidson_pipelined_device(
                    mv, x0, diag, nroots=1, tol=1e-9, operands=ops)
        assert len(linalg._PL_PROGRAMS) <= 4
        assert any("program cache overflowed" in str(w.message)
                   for w in rec)
    finally:
        linalg._PL_PROGRAMS_MAX = old_max
        linalg._PL_PROGRAMS.clear()
        linalg._PL_PROGRAMS.update(saved)
        linalg._PL_WARNED[0] = saved_warn
