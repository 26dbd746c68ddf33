"""ECW-CCS device kernels (JAX, pure functions, jit-safe).

Re-implements every equation of the reference CCS module (CCS.py) as
einsum/dot_general chains over the GEris pytree:
  - rdm1 builders: gamma_unsym / gamma_es / gamma_tr / gamma (CCS.py:23-190)
  - T1 intermediates + SCF update with ES-coupling Vexp terms (CCS.py:288-488)
  - Lambda1 intermediates + update (CCS.py:511-768)
  - ES R1/R0/L1/L0 intermediates + updates, energy extraction (CCS.py:774-1518)
  - L1-regularized updates via the vectorized subgradient (CCS.py:353-384,585-617)

Conventions (must match reference exactly, SURVEY.md section 2.2):
  - amplitudes (nocc, nvir); fock diagonal used in the update denominators;
  - Vexp enters as v = -Vexp[n,m] blocks;
  - ES updates divide by (Em + f_ii - f_aa).

ES-state lists are passed as stacked arrays (n_es, ...) so a fixed state
count jits once; `None` potentials become zero matrices (mathematically
identical to the reference's skip-if-None branches).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ecw_cc_tpu.ops.l1reg import subdiff

from ecw_cc_tpu.ops.gemm import gemm_einsum as einsum  # flat-GEMM: 11x einsum pathology fix (ops/gemm.py)


# ---------------------------------------------------------------------------
# rdm1 builders (reference CCS.py:23-190)
# ---------------------------------------------------------------------------

def gamma_unsym_CCS(ts, ls):
    """Unsymmetrized CCS one-particle rdm1 (GS). Reference CCS.py:23-48."""
    nocc, nvir = ts.shape
    doo = -einsum("ie,je->ij", ts, ls)
    dvv = einsum("ib,ia->ab", ts, ls)
    dvo = ls.T
    dov = -einsum("ja,ib,jb->ia", ts, ts, ls) + ts
    dm1 = jnp.block([[doo, dov], [dvo, dvv]])
    return dm1 + jnp.diag(jnp.concatenate([jnp.ones(nocc, dm1.dtype), jnp.zeros(nvir, dm1.dtype)]))


def gamma_es_CCS(ts, ln, rk, r0k, l0n):
    """Unsymmetrized CCS ES rdm1 <Psi_n|ap+.aq|Psi_k>. Reference CCS.py:51-102.
    GS case handled by the caller passing rk=0, r0k=1, l0n=0."""
    nocc, nvir = ts.shape
    doo = -r0k * einsum("ie,je->ij", ts, ln) - einsum("ie,je->ij", rk, ln)
    dvo = r0k * ln.T
    dvv = r0k * einsum("mb,ma->ab", ts, ln) + einsum("mb,ma->ab", rk, ln)
    tmp = einsum("ja,jb->ab", ts, ln)
    dov = (-r0k * einsum("ib,ab->ia", ts, tmp)
           - einsum("ma,ie,me->ia", ts, rk, ln)
           - einsum("ie,ma,me->ia", ts, rk, ln)
           + ts + l0n * rk)
    dm1 = jnp.block([[doo, dov], [dvo, dvv]])
    return dm1 + jnp.diag(jnp.concatenate([jnp.ones(nocc, dm1.dtype), jnp.zeros(nvir, dm1.dtype)]))


def gamma_tr_CCS(ts, ln, rk, r0k, l0n):
    """Transition rdm1: gamma_es without the HF diagonal. Reference CCS.py:105-154."""
    nocc, nvir = ts.shape
    doo = -r0k * einsum("ie,je->ij", ts, ln) - einsum("ie,je->ij", rk, ln)
    dvo = r0k * ln.T
    dvv = r0k * einsum("mb,ma->ab", ts, ln) + einsum("mb,ma->ab", rk, ln)
    tmp = einsum("ja,jb->ab", ts, ln)
    dov = (-r0k * einsum("ib,ab->ia", ts, tmp)
           - einsum("ma,ie,me->ia", ts, rk, ln)
           - einsum("ie,ma,me->ia", ts, rk, ln)
           + ts + l0n * rk)
    return jnp.block([[doo, dov], [dvo, dvv]])


def gamma_CCS(ts, ls):
    """Symmetrized GS rdm1 (PySCF convention, t2=l2=0). Reference CCS.py:157-190."""
    nocc, nvir = ts.shape
    doo = -einsum("ja,ia->ij", ts, ls)
    dvv = einsum("ia,ib->ab", ts, ls)
    xtv = einsum("ie,me->im", ts, ls)
    dvo = ts.T - einsum("im,ma->ai", xtv, ts)
    dov = ls
    top = jnp.concatenate([doo + doo.T, dov + dvo.T], axis=1)
    bot = jnp.concatenate([(dov + dvo.T).T, dvv + dvv.T], axis=1)
    dm1 = 0.5 * jnp.concatenate([top, bot], axis=0)
    return dm1 + jnp.diag(jnp.concatenate([jnp.ones(nocc, dm1.dtype), jnp.zeros(nvir, dm1.dtype)]))


# ---------------------------------------------------------------------------
# Energy (reference CCS.py:226-249)
# ---------------------------------------------------------------------------

def energy_ccs(eris, ts, fsp, rsn=None, r0n=None, vn=None):
    """E'_0; optional ES contributions from stacked rsn (n,?,?), r0n (n,), vn (n,dim,dim)."""
    nocc, nvir = ts.shape
    fsp = eris.fock if fsp is None else fsp
    e = einsum("ia,ia", fsp[:nocc, nocc:], ts)
    e = e + 0.5 * einsum("ia,jb,ijab", ts, ts, eris.oovv)
    if rsn is not None:
        v_ov = -vn[:, :nocc, nocc:]
        v_oo = -vn[:, :nocc, :nocc]
        e = e + einsum("nia,nia", v_ov, rsn)
        e = e + einsum("n,nia,ia", r0n, v_ov, ts)
        e = e + einsum("n,njj", r0n, v_oo)
    return e


# ---------------------------------------------------------------------------
# T1 intermediates and updates (reference CCS.py:271-488)
# ---------------------------------------------------------------------------

def T1inter(eris, ts, fsp):
    """'Stasis' T1 intermediates. Reference CCS.py:406-440."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvo, fvv = f[nocc:, :nocc], f[nocc:, nocc:]

    Fai = fvo + einsum("jb,jabi->ai", ts, eris.ovvo)
    Fab = fvv - einsum("jb,ja->ab", fov, ts) + einsum("jc,jacb->ab", ts, eris.ovvv)
    tmp = einsum("kc,jkcb->jb", ts, eris.oovv)
    Fji = (foo + einsum("kb,kjbi->ji", ts, eris.oovo)
           - einsum("ib,jb->ji", ts, tmp))
    return Fab, Fji, Fai


def T1inter_Stanton(eris, ts, fsp):
    """Stanton-paper T1 intermediates. Reference CCS.py:442-488."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvo, fvv = f[nocc:, :nocc], f[nocc:, nocc:]

    tsts = einsum("ia,jb->ijab", 0.125 * ts, ts)
    tsts = tsts - tsts.transpose(1, 0, 2, 3)
    tau = tsts - tsts.transpose(0, 1, 3, 2)

    Fae = (fvv - 0.5 * einsum("me,ma->ae", fov, ts)
           + einsum("mf,amef->ae", ts, eris.vovv)
           - 0.5 * einsum("mnaf,mnef->ae", 2.0 * tau, eris.oovv))
    Fmi = (foo + 0.5 * einsum("ie,me->mi", ts, fov)
           + einsum("ne,mnie->mi", ts, eris.ooov)
           + 0.5 * einsum("inef,mnef->mi", 2.0 * tau, eris.oovv))
    Fai = fvo + einsum("me,amie->ai", ts, eris.voov)
    return Fae, Fmi, Fai


def T1eq(eris, ts, fsp):
    """T1 equation value (residual form). Reference CCS.py:271-286."""
    Fab, Fji, Fai = T1inter(eris, ts, fsp)
    return Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)


def _remove_diag(F, diag):
    return F - jnp.diag(diag)


def tsupdate(eris, ts, T1i, rsn=None, r0n=None, vn=None):
    """SCF update of t1 with optional ES-coupling Vexp terms. Reference CCS.py:288-351.

    rsn: (n_es, nocc, nvir); r0n: (n_es,); vn: (n_es, dim, dim) with zeros for
    absent potentials (equivalent to the reference's skip-if-None)."""
    Fab, Fji, Fai = T1i
    nocc, nvir = ts.shape
    diag_vv = jnp.diag(eris.fock)[nocc:]
    diag_oo = jnp.diag(eris.fock)[:nocc]
    Fab = _remove_diag(Fab, diag_vv)
    Fji = _remove_diag(Fji, diag_oo)

    tsnew = Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)

    if rsn is not None:
        v_oo = -vn[:, :nocc, :nocc]
        v_vv = -vn[:, nocc:, nocc:]
        v_ov = -vn[:, :nocc, nocc:]
        # Z intermediates (CCS.py:328-347), batched over states
        Z = einsum("njj->n", v_oo) + einsum("njb,jb->n", v_ov, ts)
        Z0 = (v_ov + einsum("ib,nab->nia", ts, v_vv)
              - einsum("ja,nji->nia", ts, v_oo)
              - einsum("ja,njb,ib->nia", ts, v_ov, ts))
        Zab = v_vv - einsum("ja,njb->nab", ts, v_ov)
        Zji = -v_oo - einsum("ib,njb->nji", ts, v_ov)
        tsnew = tsnew + einsum("nia,n->ia", rsn, Z)
        tsnew = tsnew + einsum("n,nia->ia", r0n, Z0)
        tsnew = tsnew + einsum("nab,nib->ia", Zab, rsn)
        tsnew = tsnew + einsum("nji,nja->ia", Zji, rsn)

    return tsnew / (diag_oo[:, None] - diag_vv[None, :])


def tsupdate_L1(eris, ts, T1i, alpha):
    """SCF + L1-regularized t1 update. Reference CCS.py:353-384."""
    Fab, Fji, Fai = T1i
    nocc, nvir = ts.shape
    diag_vv = jnp.diag(eris.fock)[nocc:]
    diag_oo = jnp.diag(eris.fock)[:nocc]
    T1 = Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)
    dW = subdiff(T1, ts, alpha)
    eia = diag_oo[:, None] - diag_vv[None, :]
    return (dW + ts * eia) / eia


# ---------------------------------------------------------------------------
# Lambda1 intermediates and updates (reference CCS.py:490-768)
# ---------------------------------------------------------------------------

def L1inter(eris, ts, fsp, E_term=True):
    """'Stasis' Lambda1 intermediates. Reference CCS.py:649-698."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = f[:nocc, :nocc], f[:nocc, nocc:], f[nocc:, nocc:]

    Fba = (fvv - einsum("ja,jb->ba", fov, ts)
           + einsum("jbca,jc->ba", eris.ovvv, ts))
    tmp = einsum("jkca,jc->ka", eris.oovv, ts)
    Fba = Fba - einsum("ka,kb->ba", tmp, ts)

    Fij = (foo + einsum("ib,jb->ij", fov, ts)
           + einsum("kibj,kb->ij", eris.oovo, ts))
    tmp = einsum("kibc,kb->ic", eris.oovv, ts)
    Fij = Fij + einsum("ic,jc->ij", tmp, ts)

    Wbija = eris.voov - einsum("kija,kb->bija", eris.ooov, ts)
    tmp = einsum("kica,kb->icab", eris.oovv, ts)
    Wbija = Wbija - einsum("icab,jc->bija", tmp, ts)
    Wbija = Wbija + einsum("bica,jc->bija", eris.vovv, ts)

    Fia = fov + einsum("jiba,jb->ia", eris.oovv, ts)

    if E_term:
        E = -einsum("jb,jb", ts, fov) - 0.5 * einsum("jb,kc,jkbc", ts, ts, eris.oovv)
    else:
        E = jnp.asarray(0.0, dtype=ts.dtype)
    return Fia, Fba, Fij, Wbija, E


def L1inter_Stanton(eris, ts, fsp):
    """Stanton-95 Lambda1 intermediates with t2=0. Reference CCS.py:700-768."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = f[:nocc, :nocc], f[:nocc, nocc:], f[nocc:, nocc:]

    tsts = einsum("ia,jb->ijab", 0.25 * ts, ts)
    tsts = tsts - tsts.transpose(1, 0, 2, 3)
    tau = tsts - tsts.transpose(0, 1, 3, 2)

    TFea = (fvv - 0.5 * einsum("ma,me->ea", fov, ts)
            + einsum("mf,emaf->ea", ts, eris.vovv)
            - 0.5 * einsum("mnef,mnaf->ea", tau, eris.oovv))
    TFie = fov + einsum("nf,inef->ie", ts, eris.oovv)
    TFim = (foo + 0.5 * einsum("me,ie->im", ts, fov)
            + einsum("ne,inme->im", ts, eris.ooov)
            + 0.5 * einsum("mnef,inef->im", tau, eris.oovv))
    Fea = TFea - 0.5 * einsum("me,ma->ea", ts, TFie)
    Fim = TFim + 0.5 * einsum("me,ie->im", ts, TFie)

    Weima = eris.ovvo + einsum("mf,ieaf->ieam", ts, eris.ovvv)
    Weima = Weima - einsum("ne,inam->ieam", ts, eris.oovo)
    Weima = Weima - einsum("mf,ne,inaf->ieam", ts, ts, eris.oovv)
    Weima = Weima.transpose(1, 0, 3, 2)  # ieam -> eima

    Fia = TFie
    E = jnp.asarray(0.0, dtype=ts.dtype)
    return Fia, Fea, Fim, Weima, E


def L1eq(eris, ts, ls, fsp, E_term=True):
    """Lambda1 equation value. Reference CCS.py:490-509."""
    Fia, Fba, Fij, Wbija, E = L1inter(eris, ts, fsp, E_term=E_term)
    return (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
            + einsum("jb,bija->ia", ls, Wbija) + ls * E)


def lsupdate(eris, ts, ls, L1i, rsn=None, lsn=None, r0n=None, l0n=None, vn=None):
    """SCF update of lambda1 with optional ES coupling. Reference CCS.py:511-583."""
    Fia, Fba, Fij, Wbija, E = L1i
    nocc, nvir = ls.shape
    diag_vv = jnp.diag(eris.fock)[nocc:]
    diag_oo = jnp.diag(eris.fock)[:nocc]
    Fba = _remove_diag(Fba, diag_vv)
    Fij = _remove_diag(Fij, diag_oo)

    lsnew = (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
             + einsum("jb,bija->ia", ls, Wbija) + ls * E)

    if rsn is not None:
        v_oo = -vn[:, :nocc, :nocc]
        v_vv = -vn[:, nocc:, nocc:]
        v_ov = -vn[:, :nocc, nocc:]
        # P intermediates (CCS.py:555-579), batched over states
        Pl = (einsum("njb,njb->n", rsn, v_ov)
              + r0n * einsum("jb,njb->n", ts, v_ov)
              + r0n * einsum("njj->n", v_oo))
        P = einsum("njj->n", v_oo) + einsum("jb,njb->n", ts, v_ov)
        Pba = v_vv - einsum("jb,nja->nba", ts, v_ov)
        Pij = -v_oo - einsum("jb,nib->nij", ts, v_ov)
        lsnew = lsnew + ls * jnp.sum(Pl)
        lsnew = lsnew + einsum("n,nia->ia", l0n, v_ov)
        lsnew = lsnew + einsum("nia,n->ia", lsn, P)
        lsnew = lsnew + einsum("nib,nba->ia", lsn, Pba)
        lsnew = lsnew + einsum("nja,nij->ia", lsn, Pij)

    return lsnew / (diag_oo[:, None] - diag_vv[None, :])


def lsupdate_L1(eris, ls, L1i, alpha):
    """SCF + L1-regularized lambda1 update. Reference CCS.py:585-617."""
    Fia, Fba, Fij, Wbija, E = L1i
    nocc, nvir = ls.shape
    diag_vv = jnp.diag(eris.fock)[nocc:]
    diag_oo = jnp.diag(eris.fock)[:nocc]
    L1 = (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
          + einsum("jb,bija->ia", ls, Wbija) + ls * E)
    dW = subdiff(L1, ls, alpha)
    eia = diag_oo[:, None] - diag_vv[None, :]
    return (dW + ls * eia) / eia


# ---------------------------------------------------------------------------
# ES: R1 equations (reference CCS.py:774-985)
# ---------------------------------------------------------------------------

def R1inter(eris, ts, fsp, vm):
    """R1 intermediates for one excited state. Reference CCS.py:774-872.
    vm: the V^{m0} coupling potential (dim x dim) or zeros."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvo, fvv = f[nocc:, :nocc], f[nocc:, nocc:]

    Fab = (fvv - einsum("ja,jb->ab", ts, fov)
           + einsum("jc,jacb->ab", ts, eris.ovvv)
           - einsum("jc,ka,jkcb->ab", ts, ts, eris.oovv))
    Fji = (foo + einsum("ib,jb->ji", ts, fov)
           + einsum("kb,kjbi->ji", ts, eris.oovo)
           + einsum("kb,ic,kjbc->ji", ts, ts, eris.oovv))
    W = (eris.voov + einsum("ib,akbc->akic", ts, eris.vovv)
         - einsum("ib,ja,jkbc->akic", ts, ts, eris.oovv)
         - einsum("ja,jkic->akic", ts, eris.ooov))
    Fjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    Er = einsum("jb,jb", ts, Fjb)

    Zab = fvv - einsum("ja,jb->ab", ts, fov)
    Zji = foo + einsum("kb,kjbi->ji", ts, eris.oovo)
    tmp = einsum("ic,jkbc->ijkb", ts, eris.oovv)
    Zji = Zji - einsum("kb,ijkb->ji", ts, tmp)
    Zai = (fvo + einsum("jb,jabi->ai", ts, eris.ovvo)
           + einsum("jb,ic,jabc->ai", ts, ts, eris.ovvv))
    Tia = Zai.T + einsum("ib,ab->ia", ts, Zab) - einsum("ja,ji->ia", ts, Zji)

    if vm is None:
        Pia = jnp.zeros_like(Tia)
    else:
        v_vo = -vm[nocc:, :nocc]
        v_vv = -vm[nocc:, nocc:]
        v_oo = -vm[:nocc, :nocc]
        Pia = (v_vo + einsum("ab,ib->ai", v_vv, ts)
               - einsum("ii,ja,ib->ai", v_oo, ts, ts)).T
    return Fab, Fji, W, Er, Tia, Pia


def R1eq(rs, r0, Rinter):
    """Ria values. Reference CCS.py:965-985."""
    Fab, Fji, W, F, Tia, Pia = Rinter
    return (einsum("ab,ib->ia", Fab, rs) - einsum("ji,ja->ia", Fji, rs)
            + einsum("akic,kc->ia", W, rs) + rs * F + r0 * Tia + Pia)


def Extract_Em_r(eris, rs, r0, Rinter, ov=None):
    """Em from the largest r1 element (or given (o,v)). Reference CCS.py:874-906."""
    Fab, Fji, W, F, Zia, Pia = Rinter
    Ria = (einsum("ab,ib->ia", Fab, rs) - einsum("ji,ja->ia", Fji, rs)
           + einsum("akic,kc->ia", W, rs))
    if ov is None:
        flat = jnp.argmax(jnp.abs(rs))
        o, v = jnp.unravel_index(flat, rs.shape)
    else:
        o, v = ov
    Rov = Ria[o, v] + rs[o, v] * F + r0 * Zia[o, v] + Pia[o, v]
    return Rov / rs[o, v], o, v


def rsupdate(eris, rs, r0, Rinter, Em, force_alpha=True):
    """r1 SCF update. Reference CCS.py:908-943."""
    Fab, Fji, W, F, Zia, Pia = Rinter
    nocc, nvir = rs.shape
    diag_vv = jnp.diag(eris.fock)[nocc:]
    diag_oo = jnp.diag(eris.fock)[:nocc]
    Fab = _remove_diag(Fab, diag_vv)
    Fji = _remove_diag(Fji, diag_oo)
    rsnew = (einsum("ab,ib->ia", Fab, rs) - einsum("ji,ja->ia", Fji, rs)
             + einsum("akic,kc->ia", W, rs) + rs * F + r0 * Zia + Pia)
    rsnew = rsnew / (Em + diag_oo[:, None] - diag_vv[None, :])
    if force_alpha:
        rsnew = rsnew.at[0::2, :].set(0.0)
    return rsnew


def get_ov(ls, l0, rs, r0, ov):
    """Missing amplitude from the normality condition. Reference CCS.py:945-963."""
    o, v = ov
    r = rs.at[o, v].set(0.0)
    rov = 1.0 - r0 * l0 - einsum("ia,ia", r, ls)
    return rov / ls[o, v]


def R0inter(eris, ts, fsp, vm):
    """R0 intermediates. Reference CCS.py:987-1034."""
    nocc = ts.shape[0]
    f = eris.fock if fsp is None else fsp
    fov = f[:nocc, nocc:]
    Fjb = fov + einsum("kc,kjcb->jb", ts, eris.oovv)
    Zjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    E = einsum("jb,jb", ts, Zjb)
    vm_oo = vm[:nocc, :nocc]
    vm_ov = vm[:nocc, nocc:]
    P = einsum("jj", vm_oo) + einsum("jb,jb", ts, vm_ov)
    return Fjb, E, P


def r0update(rs, r0, Em, R0i):
    """r0 SCF update. Reference CCS.py:1081-1096."""
    Fjb, E, P = R0i
    return (einsum("jb,jb", rs, Fjb) + P + r0 * E) / Em


def R0eq(rs, r0, R0i):
    Fjb, E, P = R0i
    return einsum("jb,jb", rs, Fjb) + r0 * E + P


def r0_fromE(eris, En, t1, r1, vm0, fsp=None):
    """r0 from the R0 equation at energy En. Reference CCS.py:1116-1158."""
    nocc, nvir = r1.shape
    f = eris.fock if fsp is None else fsp
    if vm0 is None:
        vov = jnp.zeros((nocc, nvir), dtype=t1.dtype)
        voo = jnp.zeros((nocc, nocc), dtype=t1.dtype)
    else:
        vov = -vm0[:nocc, nocc:]
        voo = -vm0[:nocc, :nocc]
    fov = f[:nocc, nocc:]
    d = (En - einsum("jb,jb", t1, fov)
         - 0.5 * einsum("jb,kc,jkbc", t1, t1, eris.oovv))
    r0 = (einsum("jb,jb", r1, fov)
          + einsum("kc,jb,jkbc", r1, t1, eris.oovv)
          + einsum("jb,jb", t1, vov) + jnp.trace(voo))
    return r0 / d


# ---------------------------------------------------------------------------
# ES: L1/L0 equations (reference CCS.py:1164-1518)
# ---------------------------------------------------------------------------

def es_L1inter(eris, ts, fsp, vm):
    """ES Lambda1 intermediates. Reference CCS.py:1164-1234.
    vm: the V^{0m} coupling potential or None/zeros."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = f[:nocc, :nocc], f[:nocc, nocc:], f[nocc:, nocc:]

    Fba = (fvv - einsum("jb,ja->ba", ts, fov)
           + einsum("jc,jbca->ba", ts, eris.ovvv)
           - einsum("jc,kb,jkca->ba", ts, ts, eris.oovv))
    Fij = (foo + einsum("jb,ib->ij", ts, fov)
           + einsum("kb,kibj->ij", ts, eris.oovo)
           + einsum("kb,jc,kibc->ij", ts, ts, eris.oovv))
    W = (eris.voov - einsum("kb,kija->bija", ts, eris.ooov)
         + einsum("jc,bica->bija", ts, eris.vovv)
         - einsum("jc,kb,kica->bija", ts, ts, eris.oovv))
    Fjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    El = einsum("jb,jb", ts, Fjb)
    Zia = fov + einsum("jb,jiba->ia", ts, eris.oovv)
    if vm is None:
        P = jnp.zeros((nocc, nvir), dtype=ts.dtype)
    else:
        P = -vm[:nocc, nocc:]
    return Fba, Fij, W, El, Zia, P


def es_L1eq(ls, l0, esL1i):
    """Lia values. Reference CCS.py:1401-1421."""
    Fba, Fij, W, El, Zia, P = esL1i
    return (einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
            + einsum("jb,bija->ia", ls, W) + ls * El + l0 * Zia + P)


def Extract_Em_l(eris, ls, l0, L1i, ov=None):
    """Em from the largest l1 element. Reference CCS.py:1288-1319."""
    Fba, Fij, W, F, Zia, P = L1i
    if ov is None:
        flat = jnp.argmax(jnp.abs(ls))
        o, v = jnp.unravel_index(flat, ls.shape)
    else:
        o, v = ov
    Lia = (einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
           + einsum("jb,bija->ia", ls, W))
    Lov = Lia[o, v] + ls[o, v] * F + l0 * Zia[o, v] + P[o, v]
    return Lov / ls[o, v], o, v


def es_lsupdate(eris, ls, l0, Em, L1i, force_alpha=True):
    """ES l1 update. Reference CCS.py:1366-1399."""
    Fba, Fij, W, F, Zia, P = L1i
    nocc, nvir = ls.shape
    diag_vv = jnp.diag(eris.fock)[nocc:]
    diag_oo = jnp.diag(eris.fock)[:nocc]
    Fba = _remove_diag(Fba, diag_vv)
    Fij = _remove_diag(Fij, diag_oo)
    lsnew = (einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
             + einsum("jb,bija->ia", ls, W) + ls * F + l0 * Zia + P)
    lsnew = lsnew / (Em + diag_oo[:, None] - diag_vv[None, :])
    if force_alpha:
        lsnew = lsnew.at[0::2, :].set(0.0)
    return lsnew


def L0inter(eris, ts, fsp, vm):
    """L0 intermediates. Reference CCS.py:1236-1286."""
    nocc = ts.shape[0]
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvv, fvo = f[nocc:, nocc:], f[nocc:, :nocc]

    Fbj = (fvo - einsum("kb,kj->bj", ts, foo) + einsum("ja,ba->bj", ts, fvv)
           - einsum("jc,kb,kc->bj", ts, ts, fov))
    tmp = (eris.ovvo
           + einsum("lb,jd,lkcd->kbcj", ts, ts, eris.oovv)
           - einsum("lb,klcj->kbcj", ts, eris.oovo)
           + einsum("jd,kbcd->kbcj", ts, eris.ovvv))
    Wjb = einsum("kc,kbcj->jb", ts, tmp)
    Zjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    Z = einsum("jb,jb", ts, Zjb)
    P = einsum("ia,ia", ts, vm[:nocc, nocc:]) + jnp.trace(vm[:nocc, :nocc])
    return Fbj, Wjb, Z, P


def l0update(ls, l0, Em, L0i):
    """l0 SCF update. Reference CCS.py:1423-1439."""
    Fbj, Wjb, Z, P = L0i
    F = einsum("jb,bj", ls, Fbj)
    W = einsum("jb,jb", ls, Wjb)
    return (F + W + P + l0 * Z) / Em


def L0eq(ls, l0, L0i):
    Fbj, Wjb, El, P = L0i
    return einsum("jb,bj", ls, Fbj) + einsum("jb,jb", ls, Wjb) + l0 * El + P


def l0_fromE(eris, En, t1, l1, v0m, fsp=None):
    """l0 from the L0 equation at energy En. Reference CCS.py:1459-1518."""
    nocc, nvir = t1.shape
    f = eris.fock if fsp is None else fsp
    fov, fvv, foo = f[:nocc, nocc:], f[nocc:, nocc:], f[:nocc, :nocc]
    if v0m is None:
        vov = jnp.zeros((nocc, nvir), dtype=t1.dtype)
        voo = jnp.zeros((nocc, nocc), dtype=t1.dtype)
    else:
        vov = v0m[:nocc, nocc:]
        voo = v0m[:nocc, :nocc]

    d = En - 0.5 * einsum("jb,kc,jkbc", t1, t1, eris.oovv)

    l0 = (einsum("jb,jb", l1, fov)
          + einsum("jb,ab,ja", t1, fvv, l1)
          - einsum("jb,kb,kj", l1, t1, foo)
          - einsum("jc,kb,kc,jb", t1, t1, fov, l1)
          + einsum("jb,kc,kbcj", l1, t1, eris.ovvo))
    tmp = einsum("jb,jd->bd", l1, t1)
    l0 = l0 + einsum("bd,kb,lc,klcd", tmp, t1, t1, eris.oovv)
    tmp = einsum("jb,lb->jl", l1, t1)
    l0 = l0 - einsum("jl,kc,klcj", tmp, t1, eris.oovo)
    tmp = einsum("jb,jd->bd", l1, t1)
    l0 = l0 + einsum("bd,kc,kbcd", tmp, t1, eris.ovvv)
    l0 = l0 + einsum("ia,ia", t1, vov) + jnp.trace(voo)
    return l0 / d


def Extract_r0(eris, r1, ts, fsp, vm):
    """r0 from the quadratic R0/R1 consistency (eliminate Em between the R1
    and R0 equations: a r0^2 + b r0 + c = 0 with a = Zia/r, b = R1/r - Z,
    c = -(r.Fjb + P)).  Reference CCS.py:1036-1079; NOTE the reference
    divides the quadratic roots by c instead of 2a (and Extract_l0 by
    (x/2)*c, CCS.py:1356-1357) — the intended standard formula is used here.
    Host-side helper (python control flow); not jitted."""
    import numpy as np

    f = eris.fock if fsp is None else fsp
    Rinter = R1inter(eris, ts, f, vm)
    Fjb, Z, P = R0inter(eris, ts, f, jnp.zeros_like(f) if vm is None else vm)
    Fab, Fji, W, F, Zia, Pia = Rinter
    R1 = (einsum("ab,ib->ia", Fab, r1) - einsum("ji,ja->ia", Fji, r1)
          + einsum("kc,akic->ia", r1, W) + r1 * F + Pia)
    c = -float(einsum("jb,jb", r1, Fjb)) - float(P)
    if c == 0.0:
        return 0.0
    i, j = np.unravel_index(int(np.argmax(np.abs(np.asarray(r1)))), r1.shape)
    a = float(Zia[i, j] / r1[i, j])
    b = float(R1[i, j] / r1[i, j]) - float(Z)
    disc = b * b - 4 * a * c
    r0_1 = (-b + np.sqrt(disc)) / (2 * a)
    r0_2 = (-b - np.sqrt(disc)) / (2 * a)
    if r0_1 > 0:
        return r0_1
    if r0_2 > 0:
        return r0_2
    raise ValueError("Both solutions for r0 are negative")


def Extract_l0(eris, l1, ts, fsp, vm):
    """l0 from the quadratic L0/L1 consistency (mirror of Extract_r0 on the
    left-hand side).  Reference CCS.py:1321-1364 (with its `/ 2*c`
    precedence bug corrected to the standard quadratic formula)."""
    import numpy as np

    f = eris.fock if fsp is None else fsp
    Fba, Fij, W, F, Zia, P1 = es_L1inter(eris, ts, f,
                                         jnp.zeros_like(f) if vm is None else vm)
    Fbj, Wjb, Z, P0 = L0inter(eris, ts, f,
                              jnp.zeros_like(f) if vm is None else vm)
    L1 = (einsum("ba,ib->ia", Fba, l1) - einsum("ij,ja->ia", Fij, l1)
          + einsum("jb,bija->ia", l1, W) + l1 * F + P1)
    c = -float(einsum("jb,bj", l1, Fbj) + einsum("jb,jb", l1, Wjb)) - float(P0)
    if c == 0.0:
        return 0.0
    i, j = np.unravel_index(int(np.argmax(np.abs(np.asarray(l1)))), l1.shape)
    a = float(Zia[i, j] / l1[i, j])
    b = float(L1[i, j] / l1[i, j]) - float(Z)
    disc = b * b - 4 * a * c
    l0_1 = (-b + np.sqrt(disc)) / (2 * a)
    l0_2 = (-b - np.sqrt(disc)) / (2 * a)
    if l0_1 > 0:
        return l0_1
    if l0_2 > 0:
        return l0_2
    raise ValueError("Both solutions for l0 are negative")


class Gccs:
    """Thin class wrapper matching the reference API (CCS.py:197)."""

    def __init__(self, eris, fock=None, M_tot=None):
        self.eris = eris
        self.fock = eris.fock if fock is None else fock
        self.M_tot = 1 if M_tot is None else M_tot
        self.nocc = eris.nocc
        self.nvir = eris.nvir

    def energy_ccs(self, ts, fsp, rsn=None, r0n=None, vn=None):
        return energy_ccs(self.eris, ts, fsp, rsn, r0n, vn)

    def gamma(self, ts, ls):
        return gamma_CCS(ts, ls)

    def gamma_unsym(self, ts, ls):
        return gamma_unsym_CCS(ts, ls)

    def gamma_es(self, ts, ln, rn, r0n, l0n):
        return gamma_es_CCS(ts, ln, rn, r0n, l0n)

    def gamma_tr(self, ts, ln, rk, r0k, l0n):
        return gamma_tr_CCS(ts, ln, rk, r0k, l0n)

    def T1inter(self, ts, fsp):
        return T1inter(self.eris, ts, fsp)

    def T1inter_Stanton(self, ts, fsp):
        return T1inter_Stanton(self.eris, ts, fsp)

    def T1eq(self, ts, fsp):
        return T1eq(self.eris, ts, fsp)

    def tsupdate(self, ts, T1i, rsn=None, r0n=None, vn=None):
        return tsupdate(self.eris, ts, T1i, rsn, r0n, vn)

    def tsupdate_L1(self, ts, T1i, alpha):
        return tsupdate_L1(self.eris, ts, T1i, alpha)

    def L1inter(self, ts, fsp, E_term=True):
        return L1inter(self.eris, ts, fsp, E_term=E_term)

    def L1inter_Stanton(self, ts, fsp):
        return L1inter_Stanton(self.eris, ts, fsp)

    def L1eq(self, ts, ls, fsp, E_term=True):
        return L1eq(self.eris, ts, ls, fsp, E_term=E_term)

    def lsupdate(self, ts, ls, L1i, rsn=None, lsn=None, r0n=None, l0n=None, vn=None):
        return lsupdate(self.eris, ts, ls, L1i, rsn, lsn, r0n, l0n, vn)

    def lsupdate_L1(self, ls, L1i, alpha):
        return lsupdate_L1(self.eris, ls, L1i, alpha)

    def R1inter(self, ts, fsp, vm):
        return R1inter(self.eris, ts, fsp, vm)

    def R1eq(self, rs, r0, Rinter):
        return R1eq(rs, r0, Rinter)

    def Extract_Em_r(self, rs, r0, Rinter, ov=None):
        return Extract_Em_r(self.eris, rs, r0, Rinter, ov)

    def rsupdate(self, rs, r0, Rinter, Em, force_alpha=True):
        return rsupdate(self.eris, rs, r0, Rinter, Em, force_alpha)

    def get_ov(self, ls, l0, rs, r0, ov):
        return get_ov(ls, l0, rs, r0, ov)

    def R0inter(self, ts, fsp, vm):
        return R0inter(self.eris, ts, fsp, vm)

    def r0update(self, rs, r0, Em, R0i):
        return r0update(rs, r0, Em, R0i)

    def R0eq(self, rs, r0, R0i):
        return R0eq(rs, r0, R0i)

    def r0_fromE(self, En, t1, r1, vm0, fsp=None):
        return r0_fromE(self.eris, En, t1, r1, vm0, fsp)

    def es_L1inter(self, ts, fsp, vm):
        return es_L1inter(self.eris, ts, fsp, vm)

    def es_L1eq(self, ls, l0, esL1i):
        return es_L1eq(ls, l0, esL1i)

    def Extract_Em_l(self, ls, l0, L1i, ov=None):
        return Extract_Em_l(self.eris, ls, l0, L1i, ov)

    def es_lsupdate(self, ls, l0, Em, L1i, force_alpha=True):
        return es_lsupdate(self.eris, ls, l0, Em, L1i, force_alpha)

    def L0inter(self, ts, fsp, vm):
        return L0inter(self.eris, ts, fsp, vm)

    def l0update(self, ls, l0, Em, L0i):
        return l0update(ls, l0, Em, L0i)

    def L0eq(self, ls, l0, L0i):
        return L0eq(ls, l0, L0i)

    def l0_fromE(self, En, t1, l1, v0m, fsp=None):
        return l0_fromE(self.eris, En, t1, l1, v0m, fsp)

    def Extract_r0(self, r1, ts, fsp, vm):
        return Extract_r0(self.eris, r1, ts, fsp, vm)

    def Extract_l0(self, l1, ts, fsp, vm):
        return Extract_l0(self.eris, l1, ts, fsp, vm)


# ---------------------------------------------------------------------------
# Gradient / Newton machinery (reference CCS.py:1524-2160, class ccs_gradient)
#
# Re-design: instead of the reference's ~600 lines of hand-derived
# Jacobian blocks (dT/dt, dT/dl, dL/dt, dL/dl with three Vexp-derivative
# models DV1/DV2/DV3, CCS.py:1668-2071), the Jacobian of the coupled
# (T1, Lambda1) residual system is obtained EXACTLY with jax.jacfwd through
# the full computational graph, including the Vexp(gamma(t, l)) dependence.
# This covers the reference's DV1 linear-in-gamma 'mat' model exactly and
# generalizes to every property the device Vexp supports.
# ---------------------------------------------------------------------------

class ccs_gradient:
    def __init__(self, eris, Vexp_model=1, exp_pot=None):
        self.eris = eris
        self.fock = eris.fock
        self.nocc = eris.nocc
        self.nvir = eris.nvir
        self.exp_pot = exp_pot
        # device Vexp closure (optional): exact property-model derivatives
        self._vexp_fn = None
        if exp_pot is not None and Vexp_model in (2, 3):
            from ecw_cc_tpu.ops.vexp import make_gs_vexp_device
            self._vexp_fn = make_gs_vexp_device(exp_pot)

    # -- coupled residual with the local 'mat'-linear Vexp model ----------
    def _residuals(self, ts, ls, fsp0, gamma0, L):
        """T1/Lambda1 residuals with fsp varying through the rdm1:
        fsp(t, l) = fsp0 + L (gamma(t, l) - gamma0)  (exact for 'mat')."""
        if self._vexp_fn is not None:
            rdm1 = gamma_CCS(ts, ls)
            nprop = len(self.exp_pot.prop_names[0])
            Lvec = jnp.full((nprop,), L, dtype=ts.dtype)
            V, _, _ = self._vexp_fn(rdm1, Lvec)
            fsp = self.eris.fock - V
        else:
            fsp = fsp0 + L * (gamma_CCS(ts, ls) - gamma0)
        T1 = T1eq(self.eris, ts, fsp)
        L1 = L1eq(self.eris, ts, ls, fsp, E_term=False)
        return T1, L1

    def Jacobian(self, ts, ls, fsp, L):
        """Exact Jacobian of the stacked (T1, L1) residuals w.r.t (t1, l1)."""
        import jax

        ts = jnp.asarray(ts)
        ls = jnp.asarray(ls)
        gamma0 = gamma_CCS(ts, ls)
        fsp0 = jnp.asarray(fsp)
        n = ts.size

        def stacked(x):
            t = x[:n].reshape(ts.shape)
            l = x[n:].reshape(ls.shape)
            T1, L1 = self._residuals(t, l, fsp0, gamma0, L)
            return jnp.concatenate([T1.ravel(), L1.ravel()])

        x0 = jnp.concatenate([ts.ravel(), ls.ravel()])
        J = jax.jacfwd(stacked)(x0)
        return J, stacked(x0)

    def Newton(self, ts, ls, fsp, L):
        """One Newton step on the coupled system. Reference CCS.py:2094-2124."""
        ts = jnp.asarray(ts)
        ls = jnp.asarray(ls)
        n = ts.size
        J, R = self.Jacobian(ts, ls, fsp, L)
        dx = jnp.linalg.solve(J, -R)
        tsnew = ts + dx[:n].reshape(ts.shape)
        lsnew = ls + dx[n:].reshape(ls.shape)
        return tsnew, lsnew

    def Gradient_Descent(self, beta, ts, ls, fsp, L):
        """Steepest-descent step on 1/2 |R|^2. Reference CCS.py:2126-2160."""
        import jax

        ts = jnp.asarray(ts)
        ls = jnp.asarray(ls)
        gamma0 = gamma_CCS(ts, ls)
        fsp0 = jnp.asarray(fsp)

        def objective(t, l):
            T1, L1 = self._residuals(t, l, fsp0, gamma0, L)
            return 0.5 * (jnp.sum(T1 ** 2) + jnp.sum(L1 ** 2))

        gt, gl = jax.grad(objective, argnums=(0, 1))(ts, ls)
        return ts - beta * gt, ls - beta * gl
