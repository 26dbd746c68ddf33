"""The vvvv 'ladder' contraction — the CCSD hot spot.

Reference computes Wvvvv = <ab||ef> - P(ab) t1.ovvv + 0.25 tau.oovv and then
t2 += 0.5 einsum('ijef,abef->ijab', tau, Wvvvv)  (CCSD.py:305,396-402): an
O(nocc^2 nvir^4) contraction that dominates the iteration cost (SURVEY.md
section 6).

Design:
  - the Wvvvv intermediate is NEVER materialized; the three contributions are
    contracted with tau directly:
      L1 = 0.5 tau_ijef <ab||ef>              (o^2 v^2) x (v^2 v^2) matmul
      L2 = -P_(ab) 0.5 tau_ijef t1_ma <mb||fe>   O(o^2 v^3)
      L3 = 0.125 (tau_ijef <mn||ef>) tau_mnab    O(o^4 v^2)
  - L1 is a single (nocc^2, nvir^2) x (nvir^2, nvir^2) matmul: the reshaped
    dot_general (the (ab)<->(ef) symmetry of <ab||ef> skips the transpose)
    is one FP32 GEMM that XLA hands to cuBLAS.  The production route at
    nvir >= ladder_packed_min_nvir replaces it with the packed / spin-sector
    operands below; the dense GEMM serves the small shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ecw_cc_tpu.config import get_config

from ecw_cc_tpu.ops.gemm import gemm_einsum as einsum  # flat-GEMM: 11x einsum pathology fix (ops/gemm.py)


def _ladder_mm_xla(tau_r, vvvv_r):
    # <ab||ef> = <ef||ab>  =>  contract directly without transposing vvvv
    return jax.lax.dot_general(
        tau_r, vvvv_r,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=tau_r.dtype,
    )


# ---------------------------------------------------------------------------
# Spin-sector decomposition (exact)
#
# In the G spin-orbital basis with alternating orbspin [0,1,0,1,...] (the
# GHF construction, reference Eris.py:57), a spin-free Hamiltonian makes
# <ab||ef> block-sparse in spin: it vanishes unless the spin multiset of
# (a,b) equals that of (e,f).  Only three independent sectors exist —
# (aa|aa), (bb|bb), (ab|ab) — the (ab|ba)/(ba|..) sectors follow by
# antisymmetry.  For an x antisymmetric in its last two indices (tau, t2,
# l2 all are), the v^4 ladder becomes 3 sector matmuls: 6/32 of the dense
# FLOPs and no reads of structurally-zero blocks.
# ---------------------------------------------------------------------------

def vvvv_spin_sectors(vvvv):
    """(aa, bb, ab) sectors of <ab||ef>, each (m,m,m,m) with m = nvir//2."""
    return (vvvv[0::2, 0::2, 0::2, 0::2],
            vvvv[1::2, 1::2, 1::2, 1::2],
            vvvv[0::2, 1::2, 0::2, 1::2])


@jax.jit
def _spin_structure_check(v):
    import itertools

    mx = jnp.asarray(0.0, v.dtype)
    for sa, sb, sc, sd in itertools.product((0, 1), repeat=4):
        allowed = (sa == sc and sb == sd) or (sa == sd and sb == sc)
        if allowed:
            continue
        blk = v[sa::2, sb::2, sc::2, sd::2]
        mx = jnp.maximum(mx, jnp.max(jnp.abs(blk)))
    return mx, jnp.max(jnp.abs(v))


def has_spin_structure(vvvv, rtol=1e-12):
    """True if vvvv carries the alternating-spin block sparsity: every
    spin-forbidden block (spin multiset of (a,b) != that of (e,f)) is zero.
    Exact max-abs test — works in f32 too (both ERI builders mask the
    forbidden elements to exact zeros)."""
    if vvvv.shape[0] % 2:
        return False
    mx, scale = _spin_structure_check(vvvv)
    return float(mx) <= rtol * max(float(scale), 1e-30)


def sector_vvvv_contract(sectors, x):
    """0.5 * einsum('ijef,abef->ijab', x, vvvv) via spin sectors.

    Requires x antisymmetric in (e,f) and vvvv spin-block sparse (checked at
    solver setup by has_spin_structure).  Also computes the lambda ladder
    0.5*einsum('ijcd,cdab->ijab', l2, vvvv) — identical by the (ab)<->(ef)
    pair-swap symmetry of <ab||ef>."""
    aa, bb, ab = sectors
    o = x.shape[0]
    m = aa.shape[0]
    m2 = m * m

    def mm(xs, w, scale):
        return scale * jax.lax.dot_general(
            xs.reshape(o * o, m2), w.reshape(m2, m2),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=x.dtype).reshape(o, o, m, m)

    y_aa = mm(x[:, :, 0::2, 0::2], aa, 0.5)
    y_bb = mm(x[:, :, 1::2, 1::2], bb, 0.5)
    # ab rows: ef in {ab, ba} both contribute; antisymmetry of x and W makes
    # them equal -> single matmul, factor 1.0 (= 0.5 * 2)
    y_ab = mm(x[:, :, 0::2, 1::2], ab, 1.0)

    out = jnp.zeros(x.shape, x.dtype)
    out = out.at[:, :, 0::2, 0::2].set(y_aa)
    out = out.at[:, :, 1::2, 1::2].set(y_bb)
    out = out.at[:, :, 0::2, 1::2].set(y_ab)
    # ba rows by antisymmetry in (a,b)
    out = out.at[:, :, 1::2, 0::2].set(-jnp.transpose(y_ab, (0, 1, 3, 2)))
    return out


# ---------------------------------------------------------------------------
# Antisymmetry-packed ("triangular") decomposition (exact)
#
# <ab||ef> is antisymmetric in (a,b) and in (e,f) and symmetric under the
# pair swap (ab)<->(ef).  Every ladder operand in CC (tau, t2, l2) is
# antisymmetric in its last two indices, so
#     y[ij,ab] = 0.5 sum_{ef} x[ij,ef] <ab||ef>
#              =       sum_{e<f} x[ij,ef] <ab||ef>
# and y is antisymmetric in (a,b): only the a<b half need be computed.
# Restricting both pair indices to the strict upper triangle turns the
# (o^2,v^2)x(v^2,v^2) matmul into (o^2,p)x(p,p) with p = v(v-1)/2 — exactly
# 4x fewer FLOPs and 4x less vvvv HBM traffic, with no spin-structure
# requirement (works for spin-broken targets too).  The pack/unpack are one
# gather and one scatter of o^2 v^2/2 elements per call.
# ---------------------------------------------------------------------------

class PackedVVVV(NamedTuple):
    """Upper-triangle-packed <ab||ef>: wc[A,E] = <a b||e f> with A=(a<b),
    E=(e<f) flattened in row-major pair order; nvir kept for unpacking.
    wc is symmetric (pair-swap symmetry of the antisymmetrized integral)."""
    wc: jax.Array   # (p, p), p = nvir*(nvir-1)//2


def _pack_pairs(x2, v):
    """(M, v*v) -> (M, p): keep columns (e*v+f) with e<f.  Static contiguous
    slices + one concat — no gather (a single memcpy-like pass)."""
    pieces = [jax.lax.slice_in_dim(x2, e * v + e + 1, (e + 1) * v, axis=1)
              for e in range(v - 1)]
    return jnp.concatenate(pieces, axis=1)


def _unpack_pairs(yc, v):
    """(M, p) -> (M, v*v): inverse of _pack_pairs with zeros at f <= e."""
    M = yc.shape[0]
    zcol = jnp.zeros((M, 1), yc.dtype)
    pieces = []
    off = 0
    for e in range(v):
        n = v - e - 1
        pieces.append(jnp.broadcast_to(zcol, (M, e + 1)))
        if n:
            pieces.append(jax.lax.slice_in_dim(yc, off, off + n, axis=1))
        off += n
    return jnp.concatenate(pieces, axis=1)


def pack_vvvv(vvvv):
    """Build the packed ladder operand from the dense <ab||ef> block."""
    v = vvvv.shape[0]
    wc_rows = _pack_pairs(vvvv.reshape(v * v, v * v), v)       # (v^2, p)
    wc = _pack_pairs(wc_rows.T, v)                             # (p, p)
    return PackedVVVV(wc=wc)


def packed_vvvv_contract(packed, x):
    """0.5 * einsum('ijef,abef->ijab', x, vvvv) via the triangle packing.

    Requires x antisymmetric in its last two indices (tau, t2, l2 all are).
    Also computes the lambda ladder 0.5*einsum('ijcd,cdab->ijab', l2, vvvv)
    — identical by the (ab)<->(ef) pair-swap symmetry of <ab||ef>.

    The two leading dims need not be equal (EOM-EA routes its (nocc, 1,
    nvir, nvir) ladder term through here, ops/eom_ipea.py)."""
    o, o2, v, _ = x.shape
    p = v * (v - 1) // 2
    xc = _pack_pairs(x.reshape(o * o2, v * v), v)
    yc = jax.lax.dot_general(
        xc, packed.wc,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=x.dtype)
    if packed.wc.shape[0] != p:
        # row axis zero-padded for even sharding (parallel/sharding.py)
        yc = yc[:, :p]
    z = _unpack_pairs(yc, v).reshape(o, o2, v, v)
    return z - jnp.transpose(z, (0, 1, 3, 2))


def apply_vvvv_op(vvvv_op, x):
    """Dispatch the non-dense ladder routes (PackedVVVV, SectoredVVVV, or
    alternating-layout spin sectors)."""
    if isinstance(vvvv_op, PackedVVVV):
        return packed_vvvv_contract(vvvv_op, x)
    if isinstance(vvvv_op, SectoredVVVV):
        return sectored_vvvv_contract(vvvv_op, x)
    return sector_vvvv_contract(vvvv_op, x)


def stacked_packed_contract(packed, x1, x2):
    """Both per-iteration ladders (t side on tau, lambda side on l2) as ONE
    (2 o^2, p) x (p, p) GEMM: the (p, p) packed operand — the largest block
    in HBM (680 MB at pVTZ) — is read once per iteration instead of twice,
    and the GEMM M doubles (196 -> 392), halving M-padding waste in the GEMM tiles.

    Returns (y1, y2) == (packed_vvvv_contract(packed, x1),
    packed_vvvv_contract(packed, x2)).  Requires x1/x2 antisymmetric in
    their last two indices (tau, t2, l2 all are)."""
    o, _, v, _ = x1.shape
    p = v * (v - 1) // 2
    xc = jnp.concatenate([_pack_pairs(x1.reshape(o * o, v * v), v),
                          _pack_pairs(x2.reshape(o * o, v * v), v)], axis=0)
    yc = jax.lax.dot_general(
        xc, packed.wc,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=x1.dtype)
    if packed.wc.shape[0] != p:
        yc = yc[:, :p]
    z = _unpack_pairs(yc, v).reshape(2, o, o, v, v)
    z = z - jnp.swapaxes(z, -1, -2)
    return z[0], z[1]


# ---------------------------------------------------------------------------
# Spin-SORTED sectored packing (exact; combines both decompositions)
#
# With the MO order sorted by spin within occ and vir (all alpha virtuals
# first: build_eris_device(sort_spin=True)), the spin-block sparsity of
# <ab||ef> (see vvvv_spin_sectors) meets the antisymmetry packing with NO
# strided slicing: every sector slice is a contiguous sub-block, and a mixed
# pair a<b always has a alpha, b beta.  The pair-pair ladder operand becomes
# block-diagonal over three sectors,
#     wc_aa (paa,paa)  with paa = ma(ma-1)/2   (a<b both alpha, packed)
#     wc_bb (pbb,pbb)  with pbb = mb(mb-1)/2   (both beta, packed)
#     w_ab  (ma*mb, ma*mb)                     (alpha-beta, dense: a<b is
#                                               automatic in sorted order)
# and the single (o^2,p)x(p,p) GEMM splits into three with 2.67x fewer FLOPs
# at ma=mb (1.5 m^4 vs 4 m^4 pair-products) and 2.67x less wc HBM (680 MB ->
# 256 MB at C2H2/cc-pVTZ f32).  This is the spin-sector route of
# sector_vvvv_contract rebuilt on a layout where it costs no gathers — the
# alternating-layout version lost to dense on strided slicing (module
# docstring).  Requires x antisymmetric in its last two indices AND the
# whole eris/amplitude layout spin-sorted.
# ---------------------------------------------------------------------------

class SectoredVVVV(NamedTuple):
    """Spin-sectored antisymmetry-packed <ab||ef> for the spin-SORTED MO
    layout.  Row axes (output pairs) may be zero-padded for even sharding;
    column axes are exact, so the sector dims (ma, mb) are recovered from
    the column counts (see _sector_dims)."""
    wc_aa: jax.Array   # (paa[+pad], paa)
    wc_bb: jax.Array   # (pbb[+pad], pbb)
    w_ab: jax.Array    # (ma*mb[+pad], ma*mb)


def _sector_dims(sect, nvir):
    """(ma, mb) from exact column counts: ma*mb = w_ab.shape[1] and
    ma + mb = nvir, taking ma <= mb (sorted layout: alpha block first; for
    the balanced RHF-derived GHF case ma == mb)."""
    K = sect.w_ab.shape[1]
    disc = nvir * nvir - 4 * K
    r = int(round(disc ** 0.5))
    assert r * r == disc, (nvir, K)
    ma = (nvir - r) // 2
    return ma, nvir - ma


def ensure_sorted_vvvv_op(vvvv_op, eris, info):
    """The non-dense ladder operand the sorted-layout sectored kernels
    need: pass through a prebuilt op, else pack the dense sorted eris.vvvv
    once (jitted; shared by solve_ccsd / solve_lambda / the (T) adjoint so
    chained callers don't each re-pack the v^4 block)."""
    if vvvv_op is not None:
        return vvvv_op
    if eris.vvvv.size == 0:
        raise ValueError(
            "sectored kernels need a ladder operand: eris were built with "
            "pack_ladder=True but no vvvv_op was threaded through")
    return jax.jit(pack_vvvv_sorted, static_argnums=1)(eris.vvvv, info.va)


def pack_vvvv_sorted(vvvv, ma):
    """Build the sectored-packed ladder operand from a dense <ab||ef> block
    in SORTED spin layout (alpha virtuals 0..ma-1, beta ma..).  The
    spin-forbidden blocks are structurally zero and never stored."""
    v = vvvv.shape[0]
    mb = v - ma
    return SectoredVVVV(
        wc_aa=pack_vvvv(vvvv[:ma, :ma, :ma, :ma]).wc,
        wc_bb=pack_vvvv(vvvv[ma:, ma:, ma:, ma:]).wc,
        w_ab=vvvv[:ma, ma:, :ma, ma:].reshape(ma * mb, ma * mb))


def _sector_inputs(x, ma):
    """Pack the three sector column-spaces of x (antisymmetric in its last
    two indices, sorted layout) as 2-D GEMM operands.  The two leading dims
    need not be equal (cf. packed_vvvv_contract)."""
    o, o2, v, _ = x.shape
    mb = v - ma
    M = o * o2
    x_aa = _pack_pairs(x[:, :, :ma, :ma].reshape(M, ma * ma), ma)
    x_bb = _pack_pairs(x[:, :, ma:, ma:].reshape(M, mb * mb), mb)
    x_ab = x[:, :, :ma, ma:].reshape(M, ma * mb)
    return x_aa, x_bb, x_ab


def _sector_mm(xs, w, ncols):
    y = jax.lax.dot_general(
        xs, w, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=xs.dtype)
    return y[:, :ncols] if w.shape[0] != ncols else y


def _sector_assemble(y_aa, y_bb, y_ab, o, ma, mb, dtype, o2=None):
    """Upper-triangle sector results -> full antisymmetric (o,o2,v,v)."""
    if o2 is None:
        o2 = o
    v = ma + mb
    z = jnp.zeros((o, o2, v, v), dtype)
    z = z.at[:, :, :ma, :ma].set(
        _unpack_pairs(y_aa, ma).reshape(o, o2, ma, ma))
    z = z.at[:, :, ma:, ma:].set(
        _unpack_pairs(y_bb, mb).reshape(o, o2, mb, mb))
    z = z.at[:, :, :ma, ma:].set(y_ab.reshape(o, o2, ma, mb))
    return z - jnp.transpose(z, (0, 1, 3, 2))


def sectored_vvvv_contract(sect, x):
    """0.5 * einsum('ijef,abef->ijab', x, vvvv) via spin-sorted sectors.

    Requires x antisymmetric in its last two indices and the sorted layout.
    Also computes the lambda ladder (pair-swap symmetry, as in
    packed_vvvv_contract).  Leading dims need not be equal (EOM-EA)."""
    o, o2, v, _ = x.shape
    ma, mb = _sector_dims(sect, v)
    x_aa, x_bb, x_ab = _sector_inputs(x, ma)
    y_aa = _sector_mm(x_aa, sect.wc_aa, ma * (ma - 1) // 2)
    y_bb = _sector_mm(x_bb, sect.wc_bb, mb * (mb - 1) // 2)
    y_ab = _sector_mm(x_ab, sect.w_ab, ma * mb)
    return _sector_assemble(y_aa, y_bb, y_ab, o, ma, mb, x.dtype, o2=o2)


def stacked_sectored_contract(sect, x1, x2):
    """Both per-iteration ladders as one GEMM per sector (cf.
    stacked_packed_contract): each sector operand is read once per
    iteration and the GEMM M doubles."""
    o, _, v, _ = x1.shape
    ma, mb = _sector_dims(sect, v)
    in1 = _sector_inputs(x1, ma)
    in2 = _sector_inputs(x2, ma)
    ncols = (ma * (ma - 1) // 2, mb * (mb - 1) // 2, ma * mb)
    ys = [_sector_mm(jnp.concatenate([a, b], axis=0), w, n)
          for a, b, w, n in zip(in1, in2,
                                (sect.wc_aa, sect.wc_bb, sect.w_ab), ncols)]
    M = o * o
    z1 = _sector_assemble(ys[0][:M], ys[1][:M], ys[2][:M], o, ma, mb,
                          x1.dtype)
    z2 = _sector_assemble(ys[0][M:], ys[1][M:], ys[2][M:], o, ma, mb,
                          x2.dtype)
    return z1, z2


def balanced_stacked_sectored_contract(sect, x1, x2, oa, sym=False,
                                       blocked_info=None):
    """Both per-iteration ladders with spin-BALANCED row selection.

    Requires the sorted layout AND x1/x2 with balanced spin support (the
    solver's block-diagonal Vexp gate, ops/ccsd_sect.py): the alpha-alpha /
    beta-beta column sectors receive only the (alpha,alpha) / (beta,beta)
    occupied row pairs and the alpha-beta sector only the (alpha,beta)
    rows — the (beta,alpha) output rows follow by ij-antisymmetry.  4x
    fewer GEMM rows (and 4x fewer M-tiles) than
    stacked_sectored_contract; exact, the skipped rows are structural
    zeros.

    sym=True (closed-shell mirror symmetry, spinsect gate): the beta-beta
    result EQUALS the alpha-alpha result at the same spatial indices, so
    its GEMM is skipped and wc_bb is never read.

    blocked_info: a spinsect.SectorInfo — return the results as
    SpinBlocked tensors instead of assembling dense (o,o,v,v) arrays (r5
    byte cut: the dense zero-fill + full-size antisymmetrize of two
    o^2 v^2 outputs never happens; the consumers, ops/ccsd_sect kernels,
    stay blocked to the final assembly).  x1/x2 may themselves be
    SpinBlocked (e.g. the blocked tau the t-update already builds): the
    row packs then slice the stored blocks directly — no dense operand.

    x2=None: single-ladder mode — contract only x1 and return one result
    (the in-kernel vvvv_op fallback of the sect updates, where only one
    operand exists per call)."""
    single = x2 is None
    xd = x1 if single or hasattr(x2, "blocks") else x2
    o, _, v, _ = xd.shape if not hasattr(xd, "blocks") else (
        xd.info.nocc, 0, xd.info.nvir, 0)
    ma, mb = _sector_dims(sect, v)
    ob = o - oa
    assert not sym or (oa == ob and ma == mb), (
        "sym requires equal alpha/beta sector sizes", oa, ob, ma, mb)
    paa, pbb = ma * (ma - 1) // 2, mb * (mb - 1) // 2

    def rows(x):
        if hasattr(x, "blocks"):   # SpinBlocked operand (balanced support)
            r_aa = _pack_pairs(
                x.get((0, 0, 0, 0)).reshape(oa * oa, ma * ma), ma)
            r_ab = x.get((0, 1, 0, 1)).reshape(oa * ob, ma * mb)
            if sym:
                return r_aa, None, r_ab
            r_bb = _pack_pairs(
                x.get((1, 1, 1, 1)).reshape(ob * ob, mb * mb), mb)
            return r_aa, r_bb, r_ab
        r_aa = _pack_pairs(x[:oa, :oa, :ma, :ma].reshape(oa * oa, ma * ma),
                           ma)
        r_ab = x[:oa, oa:, :ma, ma:].reshape(oa * ob, ma * mb)
        if sym:
            return r_aa, None, r_ab
        r_bb = _pack_pairs(x[oa:, oa:, ma:, ma:].reshape(ob * ob, mb * mb),
                           mb)
        return r_aa, r_bb, r_ab

    rls = [rows(x1)] if single else [rows(x1), rows(x2)]

    def cat(i):
        return rls[0][i] if single else jnp.concatenate([rls[0][i],
                                                         rls[1][i]])

    y_aa = _sector_mm(cat(0), sect.wc_aa, paa)
    y_bb = y_aa if sym else _sector_mm(cat(1), sect.wc_bb, pbb)
    y_ab = _sector_mm(cat(2), sect.w_ab, ma * mb)

    Maa, Mbb, Mab = oa * oa, ob * ob, oa * ob

    def _dt(x):
        return (next(iter(x.blocks.values())).dtype
                if hasattr(x, "blocks") else x.dtype)

    if blocked_info is not None:
        from ecw_cc_tpu.ops.spinsect import SpinBlocked

        def bassemble(k, dtype):
            A = (_unpack_pairs(y_aa[k * Maa:(k + 1) * Maa], ma)
                 .reshape(oa, oa, ma, ma).astype(dtype))
            AB = (y_ab[k * Mab:(k + 1) * Mab].reshape(oa, ob, ma, mb)
                  .astype(dtype))
            blocks = {
                (0, 0, 0, 0): A - jnp.transpose(A, (0, 1, 3, 2)),
                (0, 1, 0, 1): AB,
                # z[i_a, j_b, a_b, b_a] = -z[i_a, j_b, b_a, a_b]
                (0, 1, 1, 0): -jnp.transpose(AB, (0, 1, 3, 2)),
            }
            if not sym:
                B = (_unpack_pairs(y_bb[k * Mbb:(k + 1) * Mbb], mb)
                     .reshape(ob, ob, mb, mb).astype(dtype))
                blocks[(1, 1, 1, 1)] = B - jnp.transpose(B, (0, 1, 3, 2))
                # ij-antisymmetry rows: z[i_b, j_a, ...] = -z[j_a, i_b, ...]
                blocks[(1, 0, 0, 1)] = -jnp.transpose(AB, (1, 0, 2, 3))
                blocks[(1, 0, 1, 0)] = jnp.transpose(AB, (1, 0, 3, 2))
            return SpinBlocked("oovv", blocks, blocked_info, sym=sym)

        if single:
            return bassemble(0, _dt(x1))
        return bassemble(0, _dt(x1)), bassemble(1, _dt(x2))

    def assemble(k, dtype):
        z = jnp.zeros((o, o, v, v), dtype)
        z = z.at[:oa, :oa, :ma, :ma].set(
            _unpack_pairs(y_aa[k * Maa:(k + 1) * Maa], ma)
            .reshape(oa, oa, ma, ma))
        z = z.at[oa:, oa:, ma:, ma:].set(
            _unpack_pairs(y_bb[k * Mbb:(k + 1) * Mbb], mb)
            .reshape(ob, ob, mb, mb))
        ab = y_ab[k * Mab:(k + 1) * Mab].reshape(oa, ob, ma, mb)
        z = z.at[:oa, oa:, :ma, ma:].set(ab)
        # z[i_b, j_a, a_a, b_b] = -z[j_a, i_b, a_a, b_b] (ij-antisymmetry)
        z = z.at[oa:, :oa, :ma, ma:].set(-jnp.transpose(ab, (1, 0, 2, 3)))
        return z - jnp.transpose(z, (0, 1, 3, 2))

    if single:
        return assemble(0, _dt(x1))
    return assemble(0, _dt(x1)), assemble(1, _dt(x2))


def spin_sort_perm(orbspin, nocc):
    """Permutation (new_from_old MO indices) that sorts the G spin-orbital
    order by spin WITHIN the occupied and virtual blocks (alpha first,
    stable).  Applying it to mo_coeff columns before the ERI transform
    yields the sorted layout SectoredVVVV requires; occ/vir never mix."""
    import numpy as np

    spin = np.asarray(orbspin)
    occ = np.argsort(spin[:nocc], kind="stable")
    vir = nocc + np.argsort(spin[nocc:], kind="stable")
    return np.concatenate([occ, vir])


def resolve_mode(nvir):
    """config.ladder_mode with 'auto' resolved for this nvir: packed at
    nvir >= ladder_packed_min_nvir (measured crossover), dense below."""
    cfg = get_config()
    mode = cfg.ladder_mode
    if mode == "auto":
        mode = "packed" if nvir >= cfg.ladder_packed_min_nvir else "dense"
    return mode


def make_vvvv_op(vvvv):
    """Pick the ladder route for this vvvv block per config.ladder_mode:
    'dense' -> None; 'packed' -> PackedVVVV; 'sectors' -> spin sectors (None
    if the integrals lack alternating-spin structure); 'auto' -> see
    resolve_mode."""
    nvir = vvvv.shape[0]
    if vvvv.size == 0:
        raise ValueError(
            "dense vvvv was not materialized (build_eris_device("
            "pack_ladder=True)); pass its PackedVVVV to the solver instead "
            "of rebuilding from eris.vvvv")
    mode = resolve_mode(nvir)
    if mode == "dense":
        return None
    if mode == "packed":
        return jax.jit(pack_vvvv)(vvvv)
    if mode == "sectors":
        if has_spin_structure(vvvv):
            return jax.jit(vvvv_spin_sectors)(vvvv)
        return None
    raise ValueError(f"unknown ladder_mode {mode!r}")


def ladder_contract(eris, t1, t2, tau, vvvv_op=None, skip_quad=False,
                    L1_pre=None, Y_pre=None):
    """0.5 * einsum('ijef,abef->ijab', tau, Wvvvv) without materializing Wvvvv.

    skip_quad=True omits the quadratic 0.125 tau.oovv.tau correction (L3):
    tupdate fuses it with the identical term arising from the Woooo
    correction and applies both in one contraction.

    L1_pre: the bare-vvvv ladder already computed elsewhere (e.g. the
    stacked t+lambda GEMM, stacked_packed_contract) — skips this call's own
    route.  Y_pre: the tau.ovvv intermediate 'ijef,mbef->ijmb' already
    computed (tupdate's stacked X|Y GEMM against pre-permuted views)."""
    nocc, nvir = t1.shape

    if L1_pre is not None:
        L1 = L1_pre
    elif vvvv_op is not None:
        L1 = apply_vvvv_op(vvvv_op, tau)
    else:
        tau_r = tau.reshape(nocc * nocc, nvir * nvir)
        vvvv_r = eris.vvvv.reshape(nvir * nvir, nvir * nvir)
        L1 = 0.5 * _ladder_mm_xla(tau_r, vvvv_r)
        L1 = L1.reshape(nocc, nocc, nvir, nvir)

    # - P_(ab) part from the t1.ovvv correction to Wvvvv; the P_(ab)
    # antisymmetrization is folded into two output-index-swapped einsums
    # instead of a transpose of the o^2 v^2 result (one o^2 v^2 copy less;
    # these terms sit at their M=196-row matmul roofline otherwise)
    Y = Y_pre if Y_pre is not None else einsum("ijef,mbef->ijmb", tau,
                                               eris.ovvv)
    L2 = (einsum("ijmb,ma->ijab", Y, -0.5 * t1)
          + einsum("ijma,mb->ijab", Y, 0.5 * t1))

    if skip_quad:
        return L1 + L2

    # 0.25 tau.oovv correction contracted with tau
    X = einsum("ijef,mnef->ijmn", tau, eris.oovv)
    L3 = 0.125 * einsum("ijmn,mnab->ijab", X, tau)

    return L1 + L2 + L3
