"""ECW-CCSD device kernels (JAX, pure functions, jit-safe).

Re-implements the reference CCSD module (CCSD.py): T1/T2 and Lambda1/Lambda2
SCF updates with the effective Fock matrix fsp and optional L1 regularization
(applied to doubles only, CCSD.py:316-330), the CCSD rdm1 and transition
rdm1 builders.  The amplitude equations follow the standard factorized
spin-orbital CCSD scheme (Stanton, Gauss, Watts, Bartlett, JCP 94, 4334
(1991)), which is also what the reference/PySCF implement.

Energy-term convention: the reference adds `l1new += -l1new * E` (and same
for l2) in lupdate (CCSD.py:509-510).  The multiplicand `l1new` (instead of
`l1`) is reference behavior and is replicated under energy_term='ref';
energy_term='off' gives the textbook Lambda equations (equal to the
raw-equation oracle and PySCF), used for plain-CCSD target generation.

The vvvv ladder contraction ('ijef,abef->ijab', the hot spot flagged in
SURVEY.md section 6) is routed through ops/ladder.py: one dense XLA
dot_general, or the packed / spin-sector operands at larger nvir.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ecw_cc_tpu.ops.l1reg import subdiff
from ecw_cc_tpu.ops.ladder import ladder_contract

from ecw_cc_tpu.ops.gemm import gemm_einsum as einsum  # flat-GEMM: 11x einsum pathology fix (ops/gemm.py)


# ---------------------------------------------------------------------------
# Pre-permuted ERI views for the o^3 v^3 "soup" (round-3 throughput work)
#
# Several hot contractions consume the 238 MB (at pVTZ) ovvv block in an
# index order that forces a transpose (or a strided read) inside every
# iteration.  The permutations are loop-INVARIANT: building them once per
# solve (outside the while_loop — XLA hoists them; a one-time cost) turns
# each consumer into a plain dot on a contiguous operand.  The views are
# optional everywhere (views=None keeps the reference-ordered einsum path,
# which the host/f64 parity tests exercise).
# ---------------------------------------------------------------------------

class SoupViews(NamedTuple):
    """Loop-invariant pre-permuted operands for tupdate/lupdate.

    ovvv_vo: ovvv.transpose(1,0,3,2) — (v,o,v,v).  Serves BOTH the m3
        'kcba,ijck->ijab' term (rows (c,k), cols (a,b)) and the Zl chain
        'ibmd,mbad->ia' (rows (b,m,d), col (a)) — same layout, two reshapes.
    xy_rhs: (v*v, o*o + o*v) = [oovv^(ef),(mn) | ovvv^(ef),(mb)] — the two
        tau.(ef) contractions (quadratic X and the ladder's t1 correction Y)
        as ONE stacked M=o^2 GEMM.
    ovvv_mefa: ovvv.transpose(0,2,3,1) — serves the T1 'imef,maef->ia' dot,
        Linter's v5 'kbdc,jkcd->bj' and the l1 'ikbc,kacb->ia' /
        'icab,bc->ia' chains (amplitude-side 20 MB transposes replace the
        238 MB ovvv ones).
    ovvv_jcba: ovvv.transpose(0,3,1,2) — Linter's v1 'jbac,jc->ba'.
    vovv_mfae: vovv.transpose(1,3,0,2) — cc_Fvv's 'mf,amef->ae'."""
    ovvv_vo: jax.Array
    xy_rhs: jax.Array
    ovvv_mefa: jax.Array
    ovvv_jcba: jax.Array
    vovv_mfae: jax.Array


def make_soup_views(eris):
    nocc, nvir = eris.ooov.shape[0], eris.ovvv.shape[1]
    xy_rhs = jnp.concatenate(
        [jnp.transpose(eris.oovv, (2, 3, 0, 1)).reshape(nvir * nvir,
                                                        nocc * nocc),
         jnp.transpose(eris.ovvv, (2, 3, 0, 1)).reshape(nvir * nvir,
                                                        nocc * nvir)],
        axis=1)
    return SoupViews(
        ovvv_vo=jnp.transpose(eris.ovvv, (1, 0, 3, 2)),
        xy_rhs=xy_rhs,
        ovvv_mefa=jnp.transpose(eris.ovvv, (0, 2, 3, 1)),
        ovvv_jcba=jnp.transpose(eris.ovvv, (0, 3, 1, 2)),
        vovv_mfae=jnp.transpose(eris.vovv, (1, 3, 0, 2)))


def _dot(a, b):
    return jax.lax.dot_general(a, b,
                               dimension_numbers=(((1,), (0,)), ((), ())),
                               preferred_element_type=a.dtype)


# ---------------------------------------------------------------------------
# rdm1 (reference CCSD.py:136-182)
# ---------------------------------------------------------------------------

def gamma_inter(t1, t2, l1, l2):
    doo = -einsum("ie,je->ij", l1, t1) - 0.5 * einsum("imef,jmef->ij", l2, t2)
    dvv = einsum("ma,mb->ab", t1, l1) + 0.5 * einsum("mnea,mneb->ab", t2, l2)
    xt1 = 0.5 * einsum("mnef,inef->mi", l2, t2)
    xt2 = 0.5 * einsum("mnfa,mnfe->ae", t2, l2) + einsum("ma,me->ae", t1, l1)
    dvo = (einsum("imae,me->ai", t2, l1) - einsum("mi,ma->ai", xt1, t1)
           - einsum("ie,ae->ai", t1, xt2) + t1.T)
    dov = l1
    return doo, dov, dvo, dvv


def gamma_CCSD(t1, t2, l1, l2, inter=None):
    """Symmetrized GS rdm1 (PySCF convention). Reference CCSD.py:136-162.
    inter: precomputed (doo, dov, dvo, dvv), e.g. the sector-blocked ones
    (ops/ccsd_sect.gamma_inter_sect)."""
    doo, dov, dvo, dvv = (gamma_inter(t1, t2, l1, l2) if inter is None
                          else inter)
    nocc, nvir = dov.shape
    top = jnp.concatenate([doo + doo.T, dov + dvo.T], axis=1)
    bot = jnp.concatenate([(dov + dvo.T).T, dvv + dvv.T], axis=1)
    dm1 = 0.5 * jnp.concatenate([top, bot], axis=0)
    return dm1 + jnp.diag(jnp.concatenate(
        [jnp.ones(nocc, dm1.dtype), jnp.zeros(nvir, dm1.dtype)]))


# ---------------------------------------------------------------------------
# Transition rdm1 (reference CCSD.py:33-133, raw equations from Stanton 95)
# ---------------------------------------------------------------------------

def tr_rdm1_inter(t1, t2, l1, l2, r1, r2, r0):
    Yijem = einsum("if,jmfe->ijem", t1, l2)
    # NOTE: the reference writes einsum('me,mnea->abn', r1, l2) (CCSD.py:48),
    # which is an invalid subscript (numpy raises); the intended intermediate
    # contracted later with t1[n,b] is Y[n,a] = sum_me r_me l2_mnea.
    Yna = einsum("me,mnea->na", r1, l2)
    Yim = (-einsum("ie,me->im", t1, l1) - 0.5 * einsum("inef,mnef->im", t2, l2)) * r0
    Yim = Yim - einsum("ie,me->im", r1, l1)
    Yim = Yim - 0.5 * einsum("inef,mnef->im", r2, l2)
    Yim = Yim - einsum("ie,nf,mnef->im", t1, r1, l2)
    Yea = (-0.5 * r0 * einsum("mnaf,mnef->ea", t2, l2)
           - einsum("ma,me->ea", r1, l1)
           - 0.5 * einsum("mnaf,mnef->ea", r2, l2))
    Yea_p = -0.5 * einsum("mnaf,mnef->ea", t2, l2)
    Yanef = -0.5 * einsum("ma,mnef->anef", r1, l2)
    Yainf = einsum("imae,mnef->ainf", t2, l2)
    return Yijem, Yna, Yim, Yea, Yea_p, Yanef, Yainf


def tr_rdm1(t1, t2, l1, l2, r1, r2, r0, inter=None):
    """Transition rdm1 <Psi_m(t,l)|ap+.aq|Psi_n(t,r)>. Reference CCSD.py:75-133."""
    if inter is None:
        inter = tr_rdm1_inter(t1, t2, l1, l2, r1, r2, r0)
    Yijem, Yna, Yim, Yea, Yea_p, Yanef, Yainf = inter

    oo = (einsum("ie,je->ij", t1, l1) + 0.5 * einsum("imfe,jmfe->ij", t2, l2)) * (-r0)
    oo = oo - einsum("ie,je->ij", r1, l1) - 0.5 * einsum("imfe,jmfe->ij", r2, l2)
    oo = oo + einsum("me,ijem->ij", r1, Yijem)

    vv = (einsum("mb,am->ab", t1, l1.T) + 0.5 * einsum("mneb,mnea->ab", t2, l2)) * r0
    vv = vv + einsum("mb,ma->ab", r1, l1) + 0.5 * einsum("mneb,mnea->ab", r2, l2)
    vv = vv + einsum("nb,na->ab", t1, Yna)

    ov = r0 * l1 + einsum("imae,me->ia", l2, r1)

    vo = (r0 * einsum("imae,me->ai", t2, l1) + t1.T
          + einsum("imae,me->ai", r2, l1)
          + einsum("ie,ea->ai", r1, Yea_p)
          + einsum("inef,anef->ai", t2, Yanef)
          + einsum("nf,ainf->ai", r1, Yainf)
          + einsum("ma,im->ai", t1, Yim)
          + einsum("ea,ie->ai", Yea, t1))

    return jnp.block([[oo, ov], [vo, vv]])


def tr_rdm1_left(t1, t2, lk1, lk2):
    """Pure-L left transition rdm1 <0|L_k e^-T ap+.aq e^T|0>, in the
    REFERENCE index convention: the ov/vo blocks are the transpose of the
    det-space <p+ q> layout (tr_rdm1's own layout; verified equal to the
    swapped determinant-space matrix in tests/test_eom.py — the exact
    det-space-layout version is ops/eom.tr_rdm1_left).

    tr_rdm1's bra is implicitly (1 + L) — the reference ECW convention
    where the bra keeps unit reference weight (CCSD.py:75-133).  An
    EOM-EE left eigenvector has l0 = 0, so the bare-reference piece
    (exactly the t1.T term of the vo block at r=0, r0=1) must be
    removed or it contaminates transition moments."""
    zero1 = jnp.zeros_like(t1)
    zero2 = jnp.zeros_like(t2)
    full = tr_rdm1(t1, t2, lk1, lk2, zero1, zero2, 1.0)
    ref_piece = tr_rdm1(t1, t2, zero1, zero2, zero1, zero2, 1.0)
    return full - ref_piece


# ---------------------------------------------------------------------------
# Energy (reference CCSD.py:224-242)
# ---------------------------------------------------------------------------

def energy(eris, t1, t2, fsp):
    nocc = t1.shape[0]
    fsp = eris.fock if fsp is None else fsp
    e = einsum("ia,ia", fsp[:nocc, nocc:], t1)
    e = e + 0.25 * einsum("ijab,ijab", t2, eris.oovv)
    e = e + 0.5 * einsum("ia,jb,ijab", t1, t1, eris.oovv)
    return e


# ---------------------------------------------------------------------------
# T intermediates (reference CCSD.py:346-413; Stanton et al. 1991)
# ---------------------------------------------------------------------------

def make_tau(t2, t1a, t1b, fac=1.0):
    t1t1 = einsum("ia,jb->ijab", fac * 0.5 * t1a, t1b)
    t1t1 = t1t1 - t1t1.transpose(1, 0, 2, 3)
    return t2 + t1t1 - t1t1.transpose(0, 1, 3, 2)


def cc_Fvv(eris, t1, t2, fsp, tau_t=None, views=None):
    nocc, nvir = t1.shape
    fov, fvv = fsp[:nocc, nocc:], fsp[nocc:, nocc:]
    if tau_t is None:
        tau_t = make_tau(t2, t1, t1, fac=0.5)
    if views is not None:
        # 'mf,amef->ae' against the pre-permuted (m,f),(a,e) vovv view
        t1_vovv = _dot(t1.reshape(1, nocc * nvir),
                       views.vovv_mfae.reshape(nocc * nvir, nvir * nvir)
                       ).reshape(nvir, nvir)
    else:
        t1_vovv = einsum("mf,amef->ae", t1, eris.vovv)
    return (fvv - 0.5 * einsum("me,ma->ae", fov, t1) + t1_vovv
            - 0.5 * einsum("mnaf,mnef->ae", tau_t, eris.oovv))


def cc_Foo(eris, t1, t2, fsp, tau_t=None):
    nocc = t1.shape[0]
    fov, foo = fsp[:nocc, nocc:], fsp[:nocc, :nocc]
    if tau_t is None:
        tau_t = make_tau(t2, t1, t1, fac=0.5)
    return (foo + 0.5 * einsum("me,ie->mi", fov, t1)
            + einsum("ne,mnie->mi", t1, eris.ooov)
            + 0.5 * einsum("inef,mnef->mi", tau_t, eris.oovv))


def cc_Fov(eris, t1, t2, fsp):
    nocc = t1.shape[0]
    return fsp[:nocc, nocc:] + einsum("nf,mnef->me", t1, eris.oovv)


def cc_Woooo(eris, t1, t2):
    tau = make_tau(t2, t1, t1)
    tmp = einsum("je,mnie->mnij", t1, eris.ooov)
    W = eris.oooo + tmp - tmp.transpose(0, 1, 3, 2)
    return W + 0.25 * einsum("ijef,mnef->mnij", tau, eris.oovv)


def cc_Wvvvv(eris, t1, t2):
    tau = make_tau(t2, t1, t1)
    tmp = einsum("mb,mafe->bafe", t1, eris.ovvv)
    W = eris.vvvv - tmp + tmp.transpose(1, 0, 2, 3)
    return W + einsum("mnab,mnef->abef", tau, 0.25 * eris.oovv)


def cc_Wovvo(eris, t1, t2, views=None):
    eris_ovvo = -eris.ovov.transpose(0, 1, 3, 2)
    eris_oovo = -eris.ooov.transpose(0, 1, 3, 2)
    if views is not None:
        # contract ovvv's LAST axis directly: (m,b,e),(f) x (f),(j) — no
        # 238 MB relayout (XLA's einsum otherwise transposes the big side)
        nocc, nvir = t1.shape
        W = _dot(eris.ovvv.reshape(nocc * nvir * nvir, nvir), t1.T
                 ).reshape(nocc, nvir, nvir, nocc)
    else:
        W = einsum("jf,mbef->mbej", t1, eris.ovvv)
    W = W - einsum("nb,mnej->mbej", t1, eris_oovo)
    W = W - 0.5 * einsum("jnfb,mnef->mbej", t2, eris.oovv)
    W = W - einsum("jf,nb,mnef->mbej", t1, t1, eris.oovv)
    return W + eris_ovvo


# ---------------------------------------------------------------------------
# t update (reference CCSD.py:248-338)
# ---------------------------------------------------------------------------

def tupdate(eris, t1, t2, fsp=None, alpha=None, equation=False,
            vvvv_op=None, views=None, ladder_pre=None):
    """T1/T2 SCF update (or equation values) with optional L1 regularization
    on the doubles. Reference CCSD.py:248-338.

    vvvv_op: optional non-dense route for the <ab||ef> ladder
    (ops/ladder.py): a PackedVVVV (antisymmetry-packed, exact 4x-fewer
    FLOPs) or the (aa, bb, ab) spin sectors — selected by
    ladder.make_vvvv_op per config.ladder_mode.

    views: optional SoupViews — pre-permuted loop-invariant ERI layouts
    (make_soup_views); fuses the quadratic X and the ladder's Y into one
    stacked GEMM.  ladder_pre: the bare-vvvv ladder term precomputed by the
    solver's stacked t+lambda GEMM (ops/ladder.stacked_packed_contract)."""
    nocc, nvir = t1.shape
    fock = eris.fock
    fsp = fock if fsp is None else fsp
    fov = fsp[:nocc, nocc:]
    diag_vv = jnp.diag(fock)[nocc:]
    diag_oo = jnp.diag(fock)[:nocc]

    tau = make_tau(t2, t1, t1)
    tau_t = make_tau(t2, t1, t1, fac=0.5)
    Fvv = cc_Fvv(eris, t1, t2, fsp, tau_t=tau_t, views=views)
    Foo = cc_Foo(eris, t1, t2, fsp, tau_t=tau_t)
    Fov = cc_Fov(eris, t1, t2, fsp)
    Wovvo = cc_Wovvo(eris, t1, t2, views=views)
    # The quadratic tau.oovv.tau term enters Stanton's t2 equation twice —
    # once through the Woooo correction, once through the Wvvvv correction
    # (each 0.125) — so compute X once and apply it with weight 0.25; the
    # ladder (skip_quad=True) and the bare Woooo then omit their halves.
    # With views, X and the ladder's Y intermediate are ONE stacked GEMM
    # against the pre-permuted [oovv|ovvv] right-hand block.
    if views is not None:
        no2 = nocc * nocc
        XY = _dot(tau.reshape(no2, nvir * nvir), views.xy_rhs)
        X = XY[:, :no2].reshape(nocc, nocc, nocc, nocc)
        Y = XY[:, no2:].reshape(nocc, nocc, nocc, nvir)
    else:
        X = einsum("ijef,mnef->ijmn", tau, eris.oovv)
        Y = None
    tmp = einsum("je,mnie->mnij", t1, eris.ooov)
    Woooo = eris.oooo + tmp - tmp.transpose(0, 1, 3, 2)

    if not equation and alpha is None:
        Fvv = Fvv - jnp.diag(diag_vv)
        Foo = Foo - jnp.diag(diag_oo)

    # T1
    if views is not None:
        # 'imef,maef->ia': t2 native (i),(m,e,f) against the (m,e,f),(a)
        # pre-permuted ovvv view
        t2_ovvv = _dot(t2.reshape(nocc, nocc * nvir * nvir),
                       views.ovvv_mefa.reshape(nocc * nvir * nvir, nvir))
    else:
        t2_ovvv = einsum("imef,maef->ia", t2, eris.ovvv)
    t1new = (einsum("ie,ae->ia", t1, Fvv)
             - einsum("ma,mi->ia", t1, Foo)
             + einsum("imae,me->ia", t2, Fov)
             - einsum("nf,naif->ia", t1, eris.ovov)
             - 0.5 * t2_ovvv
             - 0.5 * einsum("mnae,mnie->ia", t2, eris.ooov)
             + fov)

    # T2
    Ftmp = Fvv - 0.5 * einsum("mb,me->be", t1, Fov)
    tmp = einsum("ijae,be->ijab", t2, Ftmp)
    t2new = tmp - tmp.transpose(0, 1, 3, 2)
    Ftmp = Foo + 0.5 * einsum("je,me->mj", t1, Fov)
    tmp = einsum("imab,mj->ijab", t2, Ftmp)
    t2new = t2new - (tmp - tmp.transpose(1, 0, 2, 3))
    t2new = t2new + eris.oovv
    t2new = t2new + 0.5 * einsum("mnab,mnij->ijab", tau, Woooo)
    t2new = t2new + 0.25 * einsum("ijmn,mnab->ijab", X, tau)
    # hot vvvv ladder: 0.5 * tau_ijef Wvvvv_abef, fused (tau & W corrections;
    # the quadratic piece was applied above via X)
    t2new = t2new + ladder_contract(eris, t1, t2, tau,
                                    vvvv_op=vvvv_op, skip_quad=True,
                                    L1_pre=ladder_pre, Y_pre=Y)
    tmp = einsum("imae,mbej->ijab", t2, Wovvo)
    tmp = tmp + einsum("ie,ma,mbje->ijab", t1, t1, eris.ovov)
    tmp = tmp - tmp.transpose(1, 0, 2, 3)
    tmp = tmp - tmp.transpose(0, 1, 3, 2)
    t2new = t2new + tmp
    if views is not None:
        # 'ie,jeba->ijab' == t1 x ovvv_vo[(e),(j,a,b)] (the m3/Zl view
        # reshaped once more — ovvv_vo[e,j,a,b] = ovvv[j,e,b,a])
        tmp = _dot(t1, views.ovvv_vo.reshape(nvir, nocc * nvir * nvir)
                   ).reshape(nocc, nocc, nvir, nvir)
    else:
        tmp = einsum("ie,jeba->ijab", t1, eris.ovvv)
    t2new = t2new + (tmp - tmp.transpose(1, 0, 2, 3))
    tmp = einsum("ma,ijmb->ijab", t1, eris.ooov)
    t2new = t2new - (tmp - tmp.transpose(0, 1, 3, 2))

    if alpha is not None:
        dW1 = t1new  # L1 reg applied on doubles only (CCSD.py:318-319)
        dW2 = subdiff(t2new, t2, alpha)
        if equation:
            return dW1, dW2
        eia = diag_oo[:, None] - diag_vv[None, :]
        eijab = eia[:, None, :, None] + eia[None, :, None, :]
        return (dW1 + t1 * eia) / eia, (dW2 + t2 * eijab) / eijab

    if not equation:
        eia = diag_oo[:, None] - diag_vv[None, :]
        eijab = eia[:, None, :, None] + eia[None, :, None, :]
        return t1new / eia, t2new / eijab
    return t1new, t2new


# ---------------------------------------------------------------------------
# Lambda intermediates + update (reference CCSD.py:419-623; PySCF gccsd_lambda)
# ---------------------------------------------------------------------------

def Linter(eris, t1, t2, fsp=None, cheap=False, views=None):
    """Lambda intermediates. Reference CCSD.py:543-623.

    cheap=True skips the wvvvo intermediate entirely — a (v,v,v,o) tensor
    (238 MB at pVTZ) whose only consumer is one l1 contraction; lupdate
    folds each of its pieces into l1new with reassociated O(o^3 v^3)-or-
    cheaper chains instead (exact, no v^3 o intermediate, and the
    O(o^2 v^4) einsum('kbad,jkcd->bcaj') piece never appears).  v4 is
    returned so lupdate can fold the v4.t1 piece.

    views (SoupViews): routes the three ovvv contractions (v1, v5, the
    wovvo t1 term) through pre-permuted/contiguous layouts so no per-
    iteration relayout of the 238 MB ovvv block is emitted; v5's dot
    exploits t2's antisymmetry in its last two indices (sign flip in
    place of a big transpose)."""
    nocc, nvir = t1.shape
    fsp = eris.fock if fsp is None else fsp
    foo, fov = fsp[:nocc, :nocc], fsp[:nocc, nocc:]
    fvo, fvv = fsp[nocc:, :nocc], fsp[nocc:, nocc:]

    tau = t2 + 2.0 * einsum("ia,jb->ijab", t1, t1)

    if views is not None:
        # 'jbac,jc->ba' against the (j,c),(b,a) pre-permuted view
        t1_ovvv = _dot(t1.reshape(1, nocc * nvir),
                       views.ovvv_jcba.reshape(nocc * nvir, nvir * nvir)
                       ).reshape(nvir, nvir)
    else:
        t1_ovvv = einsum("jbac,jc->ba", eris.ovvv, t1)
    v1 = (fvv - einsum("ja,jb->ba", fov, t1) - t1_ovvv
          + 0.5 * einsum("jkca,jkbc->ba", eris.oovv, tau))
    v2 = (foo + einsum("ib,jb->ij", fov, t1)
          - einsum("kijb,kb->ij", eris.ooov, t1)
          + 0.5 * einsum("ikbc,jkbc->ij", eris.oovv, tau))
    v3 = einsum("ijcd,klcd->ijkl", eris.oovv, tau)
    v4 = einsum("ljdb,klcd->jcbk", eris.oovv, t2) + eris.ovvo
    v5 = fvo + einsum("kc,jkbc->bj", fov, t2)
    tmp = fov - einsum("kldc,ld->kc", eris.oovv, t1)
    v5 = v5 + einsum("kc,kb,jc->bj", tmp, t1, t1)
    v5 = v5 - 0.5 * einsum("kljc,klbc->bj", eris.ooov, t2)
    if views is not None:
        # 0.5*'kbdc,jkcd->bj' == -0.5*(t2 x ovvv_mefa).T: t2[j,(k,d,c)] =
        # -t2[j,(k,c,d)] (antisymmetry), view[(k,d,c),b] = ovvv[k,b,d,c]
        v5 = v5 - 0.5 * _dot(
            t2.reshape(nocc, nocc * nvir * nvir),
            views.ovvv_mefa.reshape(nocc * nvir * nvir, nvir)).T
    else:
        v5 = v5 + 0.5 * einsum("kbdc,jkcd->bj", eris.ovvv, t2)

    w3 = (v5 + einsum("jcbk,jb->ck", v4, t1)
          + einsum("cb,jb->cj", v1, t1)
          - einsum("jk,jb->bk", v2, t1))

    woooo = 0.5 * eris.oooo + 0.25 * v3 + einsum("jilc,kc->jilk", eris.ooov, t1)
    if views is not None:
        # contract ovvv's LAST axis directly (same trick as cc_Wovvo)
        ovvv_t1 = _dot(eris.ovvv.reshape(nocc * nvir * nvir, nvir), t1.T
                       ).reshape(nocc, nvir, nvir, nocc)
    else:
        ovvv_t1 = einsum("jcbd,kd->jcbk", eris.ovvv, t1)
    wovvo = (v4 - einsum("ljdb,lc,kd->jcbk", eris.oovv, t1, t1)
             - einsum("ljkb,lc->jcbk", eris.ooov, t1)
             + ovvv_t1)
    if views is not None:
        # 'icdb,jkdb->icjk' as dot(A, B^T): both operands' contracted cols
        # are their native trailing (d,b) axes — XLA otherwise relayouts
        # the 238 MB ovvv side instead of the o^2 v^2 tau side
        ovvv_tau = _dot(
            eris.ovvv.reshape(nocc * nvir, nvir * nvir),
            tau.reshape(nocc * nocc, nvir * nvir).T
            ).reshape(nocc, nvir, nocc, nocc)
    else:
        ovvv_tau = einsum("icdb,jkdb->icjk", eris.ovvv, tau)
    wovoo = (0.25 * ovvv_tau
             + 0.5 * einsum("jkic->icjk", eris.ooov)
             + einsum("icbk,jb->icjk", v4, t1)
             - einsum("lijb,klcb->icjk", eris.ooov, t2))
    if cheap:
        wvvvo = None
    else:
        wvvvo = (einsum("jcak,jb->bcak", v4, t1)
                 + 0.25 * einsum("jlka,jlbc->bcak", eris.ooov, tau)
                 - 0.5 * einsum("jacb->bcaj", eris.ovvv)
                 + einsum("kbad,jkcd->bcaj", eris.ovvv, t2))

    E = (einsum("ia,ia", fsp[:nocc, nocc:], t1)
         + 0.25 * einsum("ijab,ijab", t2, eris.oovv)
         + 0.5 * einsum("ia,jb,ijab", t1, t1, eris.oovv))
    return dict(v1=v1, v2=v2, v4=v4, w3=w3, woooo=woooo, wovvo=wovvo,
                wovoo=wovoo, wvvvo=wvvvo, E=E)


def lupdate(eris, t1, t2, l1, l2, fsp=None, alpha=None, equation=False,
            energy_term="ref", vvvv_op=None, views=None, ladder_pre=None):
    """Lambda1/Lambda2 SCF update. Reference CCSD.py:419-535.

    energy_term: 'ref' reproduces the reference's `l1new += -l1new * E`
    (CCSD.py:509-510); 'off' gives the textbook equations (matches the
    raw-equation oracle and PySCF).

    vvvv_op: optional non-dense ladder route (ops/ladder.py: PackedVVVV
    or spin sectors) for the lambda ladder 'ijcd,cdab->ijab'.  (The wvvvo
    intermediate is never materialized on ANY route — its pieces are folded
    into l1new below with reassociated chains.)

    views: optional SoupViews (pre-permuted ovvv for the m3 'kcba' term and
    the Zl chain).  ladder_pre: the lambda-side bare-vvvv ladder term
    precomputed by the solver's stacked t+lambda GEMM (note it is computed
    from the l2 PASSED HERE — callers must stack with the same l2)."""
    nocc, nvir = t1.shape
    fock = eris.fock
    fsp = fock if fsp is None else fsp
    imds = Linter(eris, t1, t2, fsp=fsp, cheap=True, views=views)
    fov = fsp[:nocc, nocc:]
    diag_vv = jnp.diag(fock)[nocc:]
    diag_oo = jnp.diag(fock)[:nocc]

    if equation is False and alpha is None:
        v1 = imds["v1"] - jnp.diag(diag_vv)
        v2 = imds["v2"] - jnp.diag(diag_oo)
        E = imds["E"]
    else:
        v1 = imds["v1"]
        v2 = imds["v2"]
        E = jnp.asarray(0.0, dtype=t1.dtype)
    if energy_term == "off":
        E = jnp.asarray(0.0, dtype=t1.dtype)

    oovv = eris.oovv
    mba = 0.5 * einsum("klca,klcb->ba", l2, t2)
    mij = 0.5 * einsum("kicd,kjcd->ij", l2, t2)
    m3 = einsum("klab,ijkl->ijab", l2, imds["woooo"])
    tau = t2 + 2.0 * einsum("ia,jb->ijab", t1, t1)
    tmp = einsum("ijcd,klcd->ijkl", l2, tau)
    m3 = m3 + 0.25 * einsum("klab,ijkl->ijab", oovv, tmp)
    tmp = einsum("ijcd,kd->ijck", l2, t1)
    if views is not None:
        # rows (ij), cols (c,k) against the pre-permuted ovvv (c,k,a,b)
        m3 = m3 - _dot(tmp.reshape(nocc * nocc, nvir * nocc),
                       views.ovvv_vo.reshape(nvir * nocc, nvir * nvir)
                       ).reshape(nocc, nocc, nvir, nvir)
    else:
        m3 = m3 - einsum("kcba,ijck->ijab", eris.ovvv, tmp)
    if ladder_pre is not None:
        m3 = m3 + ladder_pre
    elif vvvv_op is not None:
        # lambda ladder via the packed/sector route ((ab)<->(cd) pair-swap
        # symmetry makes it the same contraction as the t2 ladder)
        from ecw_cc_tpu.ops.ladder import apply_vvvv_op
        m3 = m3 + apply_vvvv_op(vvvv_op, l2)
    else:
        m3 = m3 + 0.5 * einsum("ijcd,cdab->ijab", l2, eris.vvvv)

    l2new = oovv + m3
    fov1 = fov + einsum("kjcb,kc->jb", oovv, t1)
    tmp = einsum("ia,jb->ijab", l1, fov1)
    tmp = tmp + einsum("kica,jcbk->ijab", l2, imds["wovvo"])
    tmp = tmp - tmp.transpose(1, 0, 2, 3)
    l2new = l2new + tmp - tmp.transpose(0, 1, 3, 2)
    tmp = einsum("ka,ijkb->ijab", l1, eris.ooov)
    tmp = tmp + einsum("ijca,cb->ijab", l2, v1)
    tmp1vv = mba + einsum("ka,kb->ba", l1, t1)
    tmp = tmp + einsum("ca,ijcb->ijab", tmp1vv, oovv)
    l2new = l2new - (tmp - tmp.transpose(0, 1, 3, 2))
    if views is not None:
        # 'ic,jcba->jiba': l1 x ovvv_vo[(c),(j,a,b)] gives X[i,j,a,b];
        # the needed (j,i,b,a) axis order is a small o^2 v^2 transpose
        # of X instead of a 238 MB ovvv relayout
        tmp = _dot(l1, views.ovvv_vo.reshape(nvir, nocc * nvir * nvir)
                   ).reshape(nocc, nocc, nvir, nvir).transpose(1, 0, 3, 2)
    else:
        tmp = einsum("ic,jcba->jiba", l1, eris.ovvv)
    tmp = tmp + einsum("kiab,jk->ijab", l2, v2)
    tmp1oo = mij + einsum("ic,kc->ik", l1, t1)
    tmp = tmp - einsum("ik,kjab->ijab", tmp1oo, oovv)
    l2new = l2new + (tmp - tmp.transpose(1, 0, 2, 3))

    l1new = (fov
             + einsum("jb,ibaj->ia", l1, eris.ovvo)
             + einsum("ib,ba->ia", l1, v1)
             - einsum("ja,ij->ia", l1, v2)
             - einsum("kjca,icjk->ia", l2, imds["wovoo"])
             + einsum("ijab,jb->ia", m3, t1)
             + einsum("jiba,bj->ia", l2, imds["w3"]))
    # -l2.wvvvo folded in WITHOUT materializing the (v,v,v,o) wvvvo (238 MB
    # at pVTZ; Linter cheap=True).  Its four pieces, reassociated:
    #   v4.t1 piece        -> two O(o^3 v^2) chains
    #   0.25 ooov.tau      -> O(o^4 v^2) then O(o^4 v)
    #   -0.5 ovvv exchange -> one O(o^2 v^3) dot
    #   ovvv.t2 (O(o^2 v^4) in reference form) -> two O(o^3 v^3) chains
    tmp = einsum("ikbc,jb->ikcj", l2, t1)
    l1new = l1new - einsum("ikcj,jcak->ia", tmp, imds["v4"])
    tmp = einsum("ikbc,jlbc->ikjl", l2, tau)
    l1new = l1new - 0.25 * einsum("ikjl,jlka->ia", tmp, eris.ooov)
    if views is not None:
        # 0.5*'ikbc,kacb->ia' == -0.5*(l2 x ovvv_mefa): l2[i,(k,c,b)] =
        # -l2[i,(k,b,c)] (antisymmetry), view[(k,c,b),a] = ovvv[k,a,c,b]
        l1new = l1new - 0.5 * _dot(
            l2.reshape(nocc, nocc * nvir * nvir),
            views.ovvv_mefa.reshape(nocc * nvir * nvir, nvir))
    else:
        l1new = l1new + 0.5 * einsum("ikbc,kacb->ia", l2, eris.ovvv)
    Zl = einsum("ikbc,kmcd->ibmd", l2, t2)
    if views is not None:
        # rows (i), cols (b,m,d) against the same pre-permuted ovvv
        # (b,m,d,a) — one reshape away from the m3 view above
        l1new = l1new - _dot(
            Zl.reshape(nocc, nvir * nocc * nvir),
            views.ovvv_vo.reshape(nvir * nocc * nvir, nvir))
    else:
        l1new = l1new - einsum("ibmd,mbad->ia", Zl, eris.ovvv)
    tmp = (t1 + einsum("kc,kjcb->jb", l1, t2)
           - einsum("bd,jd->jb", tmp1vv, t1)
           - einsum("lj,lb->jb", mij, t1))
    l1new = l1new + einsum("jiba,jb->ia", oovv, tmp)
    if views is not None:
        # 'icab,bc->ia': rows (i,a), cols (b,c) of the same mefa view
        # (view[i,a,b,c] = ovvv[i,c,a,b]) — a contiguous GEMV
        l1new = l1new + _dot(
            views.ovvv_mefa.reshape(nocc * nvir, nvir * nvir),
            tmp1vv.reshape(nvir * nvir, 1)).reshape(nocc, nvir)
    else:
        l1new = l1new + einsum("icab,bc->ia", eris.ovvv, tmp1vv)
    l1new = l1new - einsum("jika,kj->ia", eris.ooov, tmp1oo)
    tmp = fov - einsum("kjba,jb->ka", oovv, t1)
    l1new = l1new - einsum("ik,ka->ia", mij, tmp)
    l1new = l1new - einsum("ca,ic->ia", mba, tmp)

    # energy terms (reference behavior: multiplies the assembled residual)
    l1new = l1new - l1new * E
    l2new = l2new - l2new * E

    if alpha is not None:
        dW1 = l1new  # L1 reg on doubles only (CCSD.py:515-516)
        dW2 = subdiff(l2new, l2, alpha)
        if equation:
            return dW1, dW2
        eia = diag_oo[:, None] - diag_vv[None, :]
        eijab = eia[:, None, :, None] + eia[None, :, None, :]
        return (dW1 + l1 * eia) / eia, (dW2 + l2 * eijab) / eijab

    if not equation:
        eia = diag_oo[:, None] - diag_vv[None, :]
        eijab = eia[:, None, :, None] + eia[None, :, None, :]
        return l1new / eia, l2new / eijab
    return l1new, l2new


class GCC:
    """Thin class wrapper matching the reference API (CCSD.py:185)."""

    def __init__(self, eris, fock=None):
        self.eris = eris
        self.fock = eris.fock if fock is None else fock
        self.nocc = eris.nocc
        self.nvir = eris.nvir

    def gamma(self, t1, t2, l1, l2):
        return gamma_CCSD(t1, t2, l1, l2)

    def gamma_inter(self, t1, t2, l1, l2):
        return gamma_inter(t1, t2, l1, l2)

    def tr_rdm1_inter(self, t1, t2, l1, l2, r1, r2, r0):
        return tr_rdm1_inter(t1, t2, l1, l2, r1, r2, r0)

    def tr_rdm1(self, t1, t2, l1, l2, r1, r2, r0, inter=None):
        return tr_rdm1(t1, t2, l1, l2, r1, r2, r0, inter)

    def energy(self, t1, t2, fsp):
        return energy(self.eris, t1, t2, fsp)

    def tupdate(self, t1, t2, fsp=None, alpha=None, equation=False,
                vvvv_op=None):
        return tupdate(self.eris, t1, t2, fsp, alpha, equation, vvvv_op)

    def lupdate(self, t1, t2, l1, l2, fsp=None, alpha=None, equation=False,
                energy_term="ref", vvvv_op=None):
        return lupdate(self.eris, t1, t2, l1, l2, fsp, alpha, equation,
                       energy_term, vvvv_op)
