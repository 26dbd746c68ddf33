"""Per-term-group XLA cost-model table for the production step (r5).

The roofline question: the pVTZ 'highest' step moves ~5.4 GB/iter by the
cost model and is bandwidth-bound; which term groups own the bytes?  This
lowers each group of the sectored+sym step (t-update, lambda-update and
ladder term groups) for CPU and reports the XLA cost model's
flops / bytes-accessed per group — chip-independent HBM-traffic proxy,
fine-grained enough to target byte cuts.

Group sums exceed the fused full step (XLA fuses across the cuts and
CSEs shared intermediates); the RANKING is what matters.

Run:  python tools/bytes_table_r5.py [pvtz|pvdz]
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")

import ecw_cc_tpu.config as config

config.set_config(x64=False, dtype="float32",
                  spin_sorted=True, soup_sector=True, soup_sym=True)
config.setup_jax()

import numpy as np          # noqa: E402
import jax.numpy as jnp     # noqa: E402

import bench                # noqa: E402
from ecw_cc_tpu.models.eris import build_eris_device  # noqa: E402
from ecw_cc_tpu.ops import ladder as ladder_ops       # noqa: E402
from ecw_cc_tpu.ops.ccsd_sect import (                # noqa: E402
    _tau_b, _wrap_eris, gamma_inter_sect, lupdate_sect, tupdate_sect)
from ecw_cc_tpu.ops.spinsect import (                 # noqa: E402
    sector_einsum as _S, sector_info, wrap)

basis = {"pvdz": "cc-pvdz", "pvtz": "cc-pvtz"}[
    sys.argv[1] if len(sys.argv) > 1 else "pvtz"]

mol, ghf = bench.build_host(basis)
eris, vvvv_op = build_eris_device(mol, ghf, dtype="float32",
                                  pack_ladder=True, sort_spin=True)
nocc, nvir = eris.nocc, eris.nvir
perm = ladder_ops.spin_sort_perm(np.asarray(ghf.orbspin), nocc)
info = sector_info(np.asarray(ghf.orbspin)[perm], nocc)
print(f"== {basis}: nocc={nocc} nvir={nvir} ==", flush=True)

diag = jnp.diag(eris.fock)
eia = diag[:nocc, None] - diag[None, nocc:]
eijab = eia[:, None, :, None] + eia[None, :, None, :]
t2 = eris.oovv / eijab
rng = np.random.default_rng(0)
t1 = jnp.asarray(rng.standard_normal((nocc, nvir)) * 0.01, jnp.float32)
l1, l2 = t1 * 0.5, t2 * 0.5
fsp = eris.fock
fov = fsp[:nocc, nocc:]
SYM = True


def _blocksum(x):
    if hasattr(x, "blocks"):
        return sum(jnp.sum(b) for b in x.blocks.values())
    return jnp.sum(x)


def W(arr, kinds):
    return wrap(arr, kinds, info, sym=SYM)


# ---- term groups of the sectored+sym step -----------------------------------

def g_t_finters(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    tau_t = _tau_b(t2b, t1b, fac=0.5)
    Fvv = (_S("mf,amef->ae", t1b, sb["vovv"]).dense()
           - 0.5 * _S("mnaf,mnef->ae", tau_t, sb["oovv"]).dense())
    Foo = (_S("ne,mnie->mi", t1b, sb["ooov"]).dense()
           + 0.5 * _S("inef,mnef->mi", tau_t, sb["oovv"]).dense())
    Fov = _S("nf,mnef->me", t1b, sb["oovv"]).dense()
    return jnp.sum(Fvv) + jnp.sum(Foo) + jnp.sum(Fov)


def g_t_wovvo_build(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    Wv = _S("jf,mbef->mbej", t1b, sb["ovvv"])
    Wv = Wv + _S("nb,mnej->mbej", t1b, sb["oovo"]).scale(-1.0)
    Wv = Wv + _S("jnfb,mnef->mbej", t2b, sb["oovv"]).scale(-0.5)
    Wv = Wv + _S("jf,nb,mnef->mbej", t1b, t1b, sb["oovv"]).scale(-1.0)
    return _blocksum(Wv)


def g_t_t2wovvo(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    tmp = _S("imae,mbej->ijab", t2b, sb["ovvo"])
    tmp = tmp + _S("ie,ma,mbje->ijab", t1b, t1b, sb["ovov"])
    tmp = tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    tmp = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    return _blocksum(tmp)


def g_t_oooo(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    tau = _tau_b(t2b, t1b)
    X = _S("ijef,mnef->ijmn", tau, sb["oovv"])
    tmp = _S("je,mnie->mnij", t1b, sb["ooov"])
    Woooo = (W(er.oooo, "oooo") + tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0))
    out = _S("mnab,mnij->ijab", tau, Woooo).scale(0.5)
    out = out + _S("ijmn,mnab->ijab", X, tau).scale(0.25)
    return _blocksum(out)


def g_t_Y(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    tau = _tau_b(t2b, t1b)
    Y = _S("ijef,mbef->ijmb", tau, sb["ovvv"])
    out = _S("ijmb,ma->ijab", Y, t1b.scale(-0.5))
    out = out + _S("ijma,mb->ijab", Y, t1b.scale(0.5))
    return _blocksum(out)


def g_t_t1soup(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    out = (_S("imae,me->ia", t2b, W(fov, "ov")).dense()
           - _S("nf,naif->ia", t1b, sb["ovov"]).dense()
           - 0.5 * _S("imef,maef->ia", t2b, sb["ovvv"]).dense()
           - 0.5 * _S("mnae,mnie->ia", t2b, sb["ooov"]).dense())
    return jnp.sum(out)


def g_t_t2one(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    tmp = _S("ijae,be->ijab", t2b, W(fsp[nocc:, nocc:], "vv"))
    out = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    tmp = _S("imab,mj->ijab", t2b, W(fsp[:nocc, :nocc], "oo"))
    out = out + (tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)).scale(-1.0)
    tmp = _S("ie,jeba->ijab", t1b, sb["ovvv"])
    out = out + tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    tmp = _S("ma,ijmb->ijab", t1b, sb["ooov"])
    out = out + (tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)).scale(-1.0)
    return _blocksum(out)


def g_ladder(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    tau = _tau_b(t2b, t1b)
    y1, y2 = ladder_ops.balanced_stacked_sectored_contract(
        vvvv_op, tau, d, info.oa, sym=SYM, blocked_info=info)
    return _blocksum(y1) + _blocksum(y2)


def g_l_vinters(er, sb, a, b, c, d):
    t1b, t2b = W(a, "ov"), W(b, "oovv")
    tau = t2b + _S("ia,jb->ijab", t1b.scale(2.0), t1b)
    v1 = (-_S("jbac,jc->ba", sb["ovvv"], t1b).dense()
          + 0.5 * _S("jkca,jkbc->ba", sb["oovv"], tau).dense())
    v2 = (-_S("kijb,kb->ij", sb["ooov"], t1b).dense()
          + 0.5 * _S("ikbc,jkbc->ij", sb["oovv"], tau).dense())
    v5 = _S("kc,jkbc->bj", W(fov, "ov"), t2b).dense()
    v5 = v5 - 0.5 * _S("kljc,klbc->bj", sb["ooov"], t2b).dense()
    v5 = v5 + 0.5 * _S("kbdc,jkcd->bj", sb["ovvv"], t2b).dense()
    return jnp.sum(v1) + jnp.sum(v2) + jnp.sum(v5)


def g_l_v4(er, sb, a, b, c, d):
    t2b = W(b, "oovv")
    v4 = _S("ljdb,klcd->jcbk", sb["oovv"], t2b)
    return _blocksum(v4)


def g_l_wovvo_l2(er, sb, a, b, c, d):
    t1b, l2b = W(a, "ov"), W(d, "oovv")
    wovvo = (sb["ovvo"]
             + _S("ljdb,lc,kd->jcbk", sb["oovv"], t1b, t1b).scale(-1.0)
             + _S("ljkb,lc->jcbk", sb["ooov"], t1b).scale(-1.0)
             + _S("jcbd,kd->jcbk", sb["ovvv"], t1b))
    tmp = _S("kica,jcbk->ijab", l2b, wovvo)
    tmp = tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    out = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    return _blocksum(out)


def g_l_wovoo(er, sb, a, b, c, d):
    t1b, t2b, l2b = W(a, "ov"), W(b, "oovv"), W(d, "oovv")
    tau = t2b + _S("ia,jb->ijab", t1b.scale(2.0), t1b)
    wovoo = (_S("icdb,jkdb->icjk", sb["ovvv"], tau).scale(0.25)
             + _S("icbk,jb->icjk", sb["ovvo"], t1b)
             + _S("lijb,klcb->icjk", sb["ooov"], t2b).scale(-1.0))
    return jnp.sum(_S("kjca,icjk->ia", l2b, wovoo).dense())


def g_l_m3(er, sb, a, b, c, d):
    t1b, t2b, l2b = W(a, "ov"), W(b, "oovv"), W(d, "oovv")
    tau = t2b + _S("ia,jb->ijab", t1b.scale(2.0), t1b)
    woooo = (W(er.oooo, "oooo").scale(0.5)
             + _S("ijcd,klcd->ijkl", sb["oovv"], tau).scale(0.25)
             + _S("jilc,kc->jilk", sb["ooov"], t1b))
    m3 = _S("klab,ijkl->ijab", l2b, woooo)
    ltau = _S("ijcd,klcd->ijkl", l2b, tau)
    m3 = m3 + _S("klab,ijkl->ijab", sb["oovv"], ltau).scale(0.25)
    lt1 = _S("ijcd,kd->ijck", l2b, t1b)
    m3 = m3 + _S("kcba,ijck->ijab", sb["ovvv"], lt1).scale(-1.0)
    return _blocksum(m3)


def g_l_l2rest(er, sb, a, b, c, d):
    t1b, t2b, l1b, l2b = W(a, "ov"), W(b, "oovv"), W(c, "ov"), W(d, "oovv")
    mba = _S("klca,klcb->ba", l2b, t2b).scale(0.5)
    mij = _S("kicd,kjcd->ij", l2b, t2b).scale(0.5)
    fov1 = W(fov, "ov") + _S("kjcb,kc->jb", sb["oovv"], t1b)
    tmp = _S("ia,jb->ijab", l1b, fov1)
    tmp = tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    out = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    tmp = _S("ka,ijkb->ijab", l1b, sb["ooov"])
    tmp1vv = mba + _S("ka,kb->ba", l1b, t1b)
    tmp = tmp + _S("ca,ijcb->ijab", tmp1vv, sb["oovv"])
    out = out + (tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)).scale(-1.0)
    tmp = _S("ic,jcba->jiba", l1b, sb["ovvv"])
    tmp1oo = mij + _S("ic,kc->ik", l1b, t1b)
    tmp = tmp + _S("ik,kjab->ijab", tmp1oo, sb["oovv"]).scale(-1.0)
    out = out + tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    return _blocksum(out)


def g_l_l1rest(er, sb, a, b, c, d):
    t1b, t2b, l1b, l2b = W(a, "ov"), W(b, "oovv"), W(c, "ov"), W(d, "oovv")
    tau = t2b + _S("ia,jb->ijab", t1b.scale(2.0), t1b)
    mba = _S("klca,klcb->ba", l2b, t2b).scale(0.5)
    mij = _S("kicd,kjcd->ij", l2b, t2b).scale(0.5)
    tmp1vv = mba + _S("ka,kb->ba", l1b, t1b)
    tmp1oo = mij + _S("ic,kc->ik", l1b, t1b)
    tmp = _S("ikbc,jb->ikcj", l2b, t1b)
    l1new = -_S("ikcj,jcak->ia", tmp, sb["ovvo"]).dense()
    tmp = _S("ikbc,jlbc->ikjl", l2b, tau)
    l1new = l1new - 0.25 * _S("ikjl,jlka->ia", tmp, sb["ooov"]).dense()
    l1new = l1new + 0.5 * _S("ikbc,kacb->ia", l2b, sb["ovvv"]).dense()
    Zl = _S("ikbc,kmcd->ibmd", l2b, t2b)
    l1new = l1new - _S("ibmd,mbad->ia", Zl, sb["ovvv"]).dense()
    tmp = (a + _S("kc,kjcb->jb", l1b, t2b).dense()
           - _S("bd,jd->jb", tmp1vv, t1b).dense()
           - _S("lj,lb->jb", mij, t1b).dense())
    l1new = l1new + _S("jiba,jb->ia", sb["oovv"], W(tmp, "ov")).dense()
    l1new = l1new + _S("icab,bc->ia", sb["ovvv"], tmp1vv).dense()
    l1new = l1new - _S("jika,kj->ia", sb["ooov"], tmp1oo).dense()
    l1new = l1new - _S("ik,ka->ia", mij, W(fov, "ov")).dense()
    l1new = l1new - _S("ca,ic->ia", mba, W(fov, "ov")).dense()
    return jnp.sum(l1new)


def g_rdm1(er, sb, a, b, c, d):
    doo, dov, dvo, dvv = gamma_inter_sect(a, b, c, d, info, sym=SYM)
    return jnp.sum(doo) + jnp.sum(dov) + jnp.sum(dvo) + jnp.sum(dvv)


def g_full_t(er, sb, a, b, c, d):
    # production composition (r5 blocked route): blocked tau shared by the
    # ladder row-packs and tupdate_sect, SpinBlocked ladder_pre
    tau = _tau_b(W(b, "oovv"), W(a, "ov"))
    lp_t, lp_l = ladder_ops.balanced_stacked_sectored_contract(
        vvvv_op, tau, d, info.oa, sym=SYM, blocked_info=info)
    o1, o2 = tupdate_sect(er, a, b, fsp, info, ladder_pre=lp_t,
                          eris_sb=sb, sym=SYM, tau_pre=tau)
    return jnp.sum(o1) + jnp.sum(o2)


def g_full_l(er, sb, a, b, c, d):
    tau = _tau_b(W(b, "oovv"), W(a, "ov"))
    lp_t, lp_l = ladder_ops.balanced_stacked_sectored_contract(
        vvvv_op, tau, d, info.oa, sym=SYM, blocked_info=info)
    o1, o2 = lupdate_sect(er, a, b, c, d, fsp, info, ladder_pre=lp_l,
                          eris_sb=sb, sym=SYM)
    return jnp.sum(o1) + jnp.sum(o2)


GROUPS = [
    ("t:F-inters", g_t_finters),
    ("t:Wovvo build", g_t_wovvo_build),
    ("t:t2.Wovvo", g_t_t2wovvo),
    ("t:oooo+quad", g_t_oooo),
    ("t:Y(tau.ovvv)", g_t_Y),
    ("t:T1 soup", g_t_t1soup),
    ("t:T2 one-index", g_t_t2one),
    ("ladder (t+l)", g_ladder),
    ("l:v1/v2/v5", g_l_vinters),
    ("l:v4", g_l_v4),
    ("l:wovvo.l2", g_l_wovvo_l2),
    ("l:wovoo.l2", g_l_wovoo),
    ("l:m3", g_l_m3),
    ("l:L2 rest", g_l_l2rest),
    ("l:L1 rest", g_l_l1rest),
    ("rdm1", g_rdm1),
    ("FULL tupdate", g_full_t),
    ("FULL lupdate", g_full_l),
]


def cost(fn):
    def step(er, a, b, c, d):
        sb = _wrap_eris(er, info, sym=SYM)
        return fn(er, sb, a, b, c, d)

    lowered = jax.jit(step, backend="cpu").lower(eris, t1, t2, l1, l2)
    c = lowered.compile().cost_analysis()
    if isinstance(c, (list, tuple)):
        c = c[0]
    return (float(c.get("flops", float("nan"))),
            float(c.get("bytes accessed", float("nan"))))


rows = []
for name, fn in GROUPS:
    fl, by = cost(fn)
    rows.append((name, fl, by))
    print(f"{name:16s}  {fl/1e9:8.2f} GF  {by/1e9:8.3f} GB", flush=True)

print("\nsorted by bytes:")
for name, fl, by in sorted(rows[:-2], key=lambda r: -r[2]):
    print(f"{name:16s}  {by/1e9:8.3f} GB  {fl/1e9:8.2f} GF")
