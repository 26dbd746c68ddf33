"""CCSD(T): perturbative triples energy + response density (JAX).

Replaces the reference's use of pyscf ccsd_t_lambda_slow / ccsd_t_rdm_slow
for CCSD(T) target densities (reference gamma_exp.py:228-248).

Energy: the standard spin-orbital (T) correction
    D_ijkabc = f_ii + f_jj + f_kk - f_aa - f_bb - f_cc
    t3c = P(i/jk) P(a/bc) [ t2_jkae <ei||bc> - t2_imbc <ma||jk> ] / D
    t3d = P(i/jk) P(a/bc) [ t1_ia <jk||bc> ] / D
    E_T = 1/36 sum t3c * D * (t3c + t3d)
(Raghavachari et al. 1989; spin-orbital form as in Crawford & Schaefer's
review).  The full t3 tensor is materialized — fine for the target-generation
molecule sizes; block over i for larger systems.

Density: instead of transcribing the Lambda-CCSD(T) equations, the unrelaxed
response density gamma_pq = dE_CCSD(T)/df_pq is computed EXACTLY by the
implicit-function theorem with JAX vjps:
    solve J(t)^T lam = -dE/dt   (GMRES, Jacobi-preconditioned by eia/eijab)
    gamma = dE/df + lam^T dR/df + HF diagonal
This is the same mathematical object pyscf's hand-derived
ccsd_t_lambda_slow + ccsd_t_rdm_slow produce (the Lambda-CCSD(T) gradient
density), obtained through functional transforms — and is verified against
finite differences in tests/test_ccsd_t.py.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ecw_cc_tpu.ops import ccsd as ccsd_ops

from ecw_cc_tpu.ops.gemm import gemm_einsum as einsum  # flat-GEMM: 11x einsum pathology fix (ops/gemm.py)


def _p_i_jk(x):
    """P(i/jk) f(i,j,k,...) = f - f(i<->j) - f(i<->k) on the first 3 axes."""
    return x - jnp.swapaxes(x, 0, 1) - jnp.swapaxes(x, 0, 2)


def _p_a_bc(x):
    """P(a/bc) on axes 3,4,5."""
    return x - jnp.swapaxes(x, 3, 4) - jnp.swapaxes(x, 3, 5)


def _t3_pieces(eris, t1, t2, fsp):
    nocc, nvir = t1.shape
    f = eris.fock if fsp is None else fsp
    fo = jnp.diag(f)[:nocc]
    fv = jnp.diag(f)[nocc:]
    D = (fo[:, None, None, None, None, None] + fo[None, :, None, None, None, None]
         + fo[None, None, :, None, None, None] - fv[None, None, None, :, None, None]
         - fv[None, None, None, None, :, None] - fv[None, None, None, None, None, :])
    # connected: W_ijkabc = P(i/jk)P(a/bc)[ t2_jkae <ei||bc> - t2_imbc <ma||jk> ]
    w = einsum("jkae,eibc->ijkabc", t2, eris.vovv)
    w = w - einsum("imbc,majk->ijkabc", t2, eris.ovoo)
    w = _p_a_bc(_p_i_jk(w))
    t3c = w / D
    # disconnected: t1_ia <jk||bc>
    v = einsum("ia,jkbc->ijkabc", t1, eris.oovv)
    v = _p_a_bc(_p_i_jk(v))
    t3d = v / D
    return t3c, t3d, D, w


def _energy_t_dense(eris, t1, t2, fsp=None):
    """(T) with the full t3 materialized — O(o^3 v^3) memory; cross-check
    oracle for the scan path on tiny systems."""
    t3c, t3d, D, w = _t3_pieces(eris, t1, t2, fsp)
    return einsum("ijkabc,ijkabc", w, t3c + t3d) / 36.0


def _sect_scan_t(eris, t1, t2, fo, fv, info, sI, sJ, mesh=None,
                 slab_dtype=None):
    """One (T) scan over (I, J) pairs with I in occupied spin sector sI and
    J in sector sJ (sorted layout).  With the pair spins STATIC, every slab
    contraction in the body decomposes over the compatible spin sectors
    only (ops/spinsect.sector_einsum with sliced_support) — the
    structurally-zero blocks of the per-pair t3 slab are never formed.

    mesh: optional jax.sharding.Mesh — the pair list is split evenly over
    ALL mesh devices (the pairs are embarrassingly parallel: operands are
    replicated, each device scans its chunk, and only the scalar energy is
    psummed over ICI).  Padded entries carry ij=-1 and are masked; clipped
    gathers at -1 read real data, so no NaNs enter the masked lanes."""
    from ecw_cc_tpu.ops import spinsect as ss

    nI = info.oa if sI == 0 else info.ob
    nJ = info.oa if sJ == 0 else info.ob
    if nI == 0 or nJ == 0:
        return jnp.asarray(0.0, t1.dtype)
    baseI = 0 if sI == 0 else info.oa
    baseJ = 0 if sJ == 0 else info.oa

    def mk_body(t2, t1, vovv, ovoo, oovv, fo, fv):
        # all operands are explicit factory args so the shard_map path can
        # rebuild the body from its (replicated) block arguments instead of
        # capturing arrays traced outside the shard
        fo_s = {0: fo[:info.oa], 1: fo[info.oa:]}
        fv_s = {0: fv[:info.va], 1: fv[info.va:]}
        # loop-invariant full-tensor views (XLA hoists slices out of scan)
        t2_b = ss.wrap(t2, "oovv", info)
        t1_b = ss.wrap(t1, "ov", info)
        vovv_b = ss.wrap(vovv, "vovv", info)

        def blk(arr, kinds_full, fixed):
            kinds, sup = ss.sliced_support(kinds_full, fixed)
            return ss.SpinBlocked.from_dense(arr, kinds, info, support=sup)

        def pabc(x):  # P(a/bc) on blocked (k,a,b,c)
            return (x + x.transpose(0, 2, 1, 3).scale(-1.0)
                    + x.transpose(0, 3, 2, 1).scale(-1.0))

        S = ss.sector_einsum

        @jax.checkpoint
        def body(acc, ij):
            valid = ij >= 0
            ij = jnp.maximum(ij, 0)
            I = baseI + ij // nJ
            J = baseJ + ij % nJ
            t2I = blk(jnp.take(t2, I, axis=0), "oovv", {0: sI})
            t2J = blk(jnp.take(t2, J, axis=0), "oovv", {0: sJ})
            vovvI = blk(jnp.take(vovv, I, axis=1), "vovv", {1: sI})
            vovvJ = blk(jnp.take(vovv, J, axis=1), "vovv", {1: sJ})
            ovooJ = blk(jnp.take(ovoo, J, axis=2), "ovoo", {2: sJ})
            ovooI = blk(jnp.take(ovoo, I, axis=2), "ovoo", {2: sI})
            t2JI = blk(jnp.take(jnp.take(t2, J, axis=0), I, axis=0),
                       "oovv", {0: sJ, 1: sI})
            ovooJI = blk(jnp.take(jnp.take(ovoo, J, axis=2), I, axis=2),
                         "ovoo", {2: sJ, 3: sI})
            t1I = blk(jnp.take(t1, I, axis=0), "ov", {0: sI})
            t1J = blk(jnp.take(t1, J, axis=0), "ov", {0: sJ})
            oovvI = blk(jnp.take(oovv, I, axis=0), "oovv", {0: sI})
            oovvJ = blk(jnp.take(oovv, J, axis=0), "oovv", {0: sJ})
            oovvJI = blk(jnp.take(jnp.take(oovv, J, axis=0), I, axis=0),
                         "oovv", {0: sJ, 1: sI})
            # P(i/jk) W0 at (I, J, k) — same terms as the dense body
            A = (S("kae,ebc->kabc", t2J, vovvI)
                 + S("mbc,mak->kabc", t2I, ovooJ).scale(-1.0))
            B = (S("kae,ebc->kabc", t2I, vovvJ)
                 + S("mbc,mak->kabc", t2J, ovooI).scale(-1.0))
            C = (S("ae,ekbc->kabc", t2JI, vovv_b)
                 + S("kmbc,ma->kabc", t2_b, ovooJI).scale(-1.0))
            w = pabc(A + B.scale(-1.0) + C.scale(-1.0))
            v0 = (S("a,kbc->kabc", t1I, oovvJ)
                  + S("a,kbc->kabc", t1J, oovvI).scale(-1.0)
                  + S("ka,bc->kabc", t1_b, oovvJI).scale(-1.0))
            v = pabc(v0)
            foIJ = jnp.take(fo, I) + jnp.take(fo, J)
            e = jnp.asarray(0.0, fo.dtype)
            for key, wblk in w.blocks.items():
                sk, sa, sb, sc = key
                D = (foIJ + fo_s[sk][:, None, None, None]
                     - fv_s[sa][None, :, None, None]
                     - fv_s[sb][None, None, :, None]
                     - fv_s[sc][None, None, None, :])
                vblk = v.get(key)
                tot = wblk if vblk is None else wblk + vblk
                # accumulate the energy at FULL precision even when the
                # slab contractions run reduced (slab_dtype='bfloat16'):
                # D is built from the full-precision fock diagonal and the
                # products promote to fo.dtype before the reduction
                e = e + jnp.sum(wblk.astype(fo.dtype)
                                * tot.astype(fo.dtype) / D)
            return acc + jnp.where(valid, e, 0.0), None

        return body

    ops = (t2, t1, eris.vovv, eris.ovoo, eris.oovv, fo, fv)
    if slab_dtype is not None:
        # reduced-precision SLABS: the five big scan
        # operands are stored/streamed at slab_dtype (bf16 halves both the
        # HBM traffic and the GEMM cost of the per-pair contractions); the
        # energy denominators (fo, fv) and the accumulation stay at full
        # precision (see the e loop above).  Exactness bound pinned by
        # tests/test_ccsd_t.py::test_energy_t_bf16_slab_error_bound.
        dt = jnp.dtype(slab_dtype)
        ops = tuple(x.astype(dt) for x in ops[:5]) + (fo, fv)

    if mesh is None:
        acc, _ = jax.lax.scan(mk_body(*ops), jnp.asarray(0.0, fo.dtype),
                              jnp.arange(nI * nJ))
        return acc

    from jax import shard_map
    from jax.sharding import PartitionSpec as Psp

    ndev = mesh.size
    axes = tuple(mesh.axis_names)
    npairs = nI * nJ
    per = -(-npairs // ndev)
    ids = np.full(ndev * per, -1, dtype=np.int32)
    ids[:npairs] = np.arange(npairs, dtype=np.int32)

    def chunk(ids_local, *ops_rep):
        # the carry must enter the scan as device-VARYING (the chunk sums
        # differ per shard) or shard_map's vma typing rejects the body
        # (pcast is the non-deprecated spelling; pvary the 0.9 fallback)
        try:
            acc0 = jax.lax.pcast(jnp.asarray(0.0, fo.dtype), axes,
                                 to="varying")
        except (AttributeError, TypeError):
            acc0 = jax.lax.pvary(jnp.asarray(0.0, fo.dtype), axes)
        acc, _ = jax.lax.scan(mk_body(*ops_rep), acc0, ids_local)
        return jax.lax.psum(acc, axes)

    run = shard_map(chunk, mesh=mesh,
                    in_specs=(Psp(axes),) + (Psp(),) * len(ops),
                    out_specs=Psp())
    return run(jnp.asarray(ids), *ops)


def energy_t_sect(eris, t1, t2, info, fsp=None, sym=False,
                  mesh=None, slab_dtype=None):
    """(T) energy with spin-sector blocking (SORTED layout; exact).

    Same per-(I,J) scan structure as energy_t, but one scan per occupied
    spin-sector pair (sI, sJ), so the body's contractions skip every
    structurally-zero spin block (~8x fewer FLOPs; ops/spinsect.py).
    sym=True (closed-shell mirror symmetry, spin-restricted eris — gate:
    eris_spin_restricted) additionally skips the (beta, *) scans and
    doubles the (alpha, alpha) + (alpha, beta) energies — exact, 2x again.

    VALIDITY: eris in the spin-sorted layout with the standard balanced
    support, amplitudes from a spin-conserving solve (plain CC on an
    RHF-derived GHF keeps the balanced structure at every iteration).

    GRADIENT EXACTNESS under sym: E_sym = 2(E00 + E01) has the right VALUE
    at a mirror-symmetric point but a FOLDED gradient (2∇(E00+E01) instead
    of the true (1+M)∇(E00+E01), M the global spin mirror — the skipped
    (beta,*) scans' t-dependence differs from the doubled ones').  The
    inputs are therefore mirror-AVERAGED first ((x + Mx)/2 — the identity
    on symmetric inputs): the chain rule then emits exactly (1+M)/2 of the
    folded gradient, i.e. the true one, so the response-density adjoint
    (ccsd_t_rdm1_response) can differentiate straight through."""
    f = eris.fock if fsp is None else fsp
    fo = jnp.diag(f)[:info.nocc]
    fv = jnp.diag(f)[info.nocc:]
    if sym:
        from ecw_cc_tpu.ops.spinsect import mirror_dense

        t1 = 0.5 * (t1 + mirror_dense(t1, "ov", info))
        t2 = 0.5 * (t2 + mirror_dense(t2, "oovv", info))
        fo = 0.5 * (fo + mirror_dense(fo, "o", info))
        fv = 0.5 * (fv + mirror_dense(fv, "v", info))
    pairs = ((0, 0), (0, 1)) if sym else ((0, 0), (0, 1), (1, 0), (1, 1))
    e = jnp.asarray(0.0, fo.dtype)
    for sI, sJ in pairs:
        e = e + _sect_scan_t(eris, t1, t2, fo, fv, info, sI, sJ, mesh=mesh,
                             slab_dtype=slab_dtype)
    if sym:
        e = e + e
    return e / 36.0


def eris_spin_restricted(eris, info, vvvv_op=None):
    """Closed-shell mirror-symmetry gate for target-generation (T): equal
    alpha/beta sector sizes and every ERI block + the Fock diagonal
    numerically flip-symmetric (an RHF-derived GHF passes at machine
    epsilon).  Host-side, once per build; no Vexp on this path.

    vvvv_op: the ladder operand consumed by the sym solves — when eris
    were built pack-on-build (vvvv is a size-0 placeholder), its sectored
    alpha-alpha vs beta-beta packs are compared directly, mirroring the
    solver-side gate (solvers/gs.py Solver_CCSD._spin_restricted): a
    transform error concentrated in the v^4 block must veto sym."""
    from ecw_cc_tpu.ops.ladder import SectoredVVVV
    from ecw_cc_tpu.ops.spinsect import spin_flip_asymmetry

    if info.oa != info.ob or info.va != info.vb:
        return False
    eps = float(jnp.finfo(eris.oovv.dtype).eps)
    d = np.asarray(jnp.diag(eris.fock))
    no, va = info.nocc, info.va
    worst = max(
        float(np.max(np.abs(d[:info.oa] - d[info.oa:no]))),
        float(np.max(np.abs(d[no:no + va] - d[no + va:]))))
    scale = max(1.0, float(np.max(np.abs(d))))
    for name in ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv", "ovoo",
                 "vovv"):
        blk = getattr(eris, name)
        if blk.size == 0:
            continue
        worst = max(worst, float(spin_flip_asymmetry(blk, name, info)))
        scale = max(scale, float(jnp.max(jnp.abs(blk))))
    if eris.vvvv.size:
        worst = max(worst, float(spin_flip_asymmetry(eris.vvvv, "vvvv",
                                                     info)))
        scale = max(scale, float(jnp.max(jnp.abs(eris.vvvv))))
    elif isinstance(vvvv_op, SectoredVVVV):
        if vvvv_op.wc_aa.shape != vvvv_op.wc_bb.shape:
            return False
        worst = max(worst, float(jnp.max(jnp.abs(vvvv_op.wc_aa
                                                 - vvvv_op.wc_bb))))
        scale = max(scale, float(jnp.max(jnp.abs(vvvv_op.wc_aa))))
    return worst <= 1e3 * eps * scale


def energy_t(eris, t1, t2, fsp=None, sect=None, mesh=None,
             slab_dtype=None):
    """The (T) energy correction, scanned over (i,j) occupied pairs.

    sect: optional (SectorInfo, sym) — route through the spin-sector-blocked
    scans (energy_t_sect; requires the sorted layout).

    The full t3 tensor is O(o^3 v^3) — 26 GB at C2H2/6-311++G(2d,2p) f32 —
    so the permutation operators are expanded per (i,j) slab: each scan step
    holds only (o, v, v, v) work arrays (~134 MB there).  The body is
    rematerialized (jax.checkpoint) so the response-density vjp does not
    store per-step slabs either."""
    if sect is not None:
        info, sym = sect
        return energy_t_sect(eris, t1, t2, info, fsp=fsp, sym=sym, mesh=mesh,
                             slab_dtype=slab_dtype)
    if slab_dtype is not None:
        raise ValueError("slab_dtype requires the sector-blocked route "
                         "(pass sect=(SectorInfo, sym))")
    if mesh is not None:
        raise ValueError("energy_t(mesh=...) requires sect: the sharded "
                         "pair scans are implemented on the sector-blocked "
                         "route only (pass sect=(SectorInfo, sym))")
    nocc, nvir = t1.shape
    f = eris.fock if fsp is None else fsp
    fo = jnp.diag(f)[:nocc]
    fv = jnp.diag(f)[nocc:]
    vovv, ovoo, oovv = eris.vovv, eris.ovoo, eris.oovv
    Dk = (fo[:, None, None, None]
          - fv[None, :, None, None] - fv[None, None, :, None]
          - fv[None, None, None, :])

    def pabc(x):  # P(a/bc) on axes 1,2,3 of (k,a,b,c)
        return x - jnp.swapaxes(x, 1, 2) - jnp.swapaxes(x, 1, 3)

    @jax.checkpoint
    def body(acc, ij):
        I, J = ij // nocc, ij % nocc
        t2I = jnp.take(t2, I, axis=0)          # (o, v, v)... (m,b,c) etc.
        t2J = jnp.take(t2, J, axis=0)
        vovvI = jnp.take(vovv, I, axis=1)      # (v, v, v) = (e, b, c)
        vovvJ = jnp.take(vovv, J, axis=1)
        ovooJ = jnp.take(ovoo, J, axis=2)      # (o, v, o) = (m, a, k)
        ovooI = jnp.take(ovoo, I, axis=2)
        # P(i/jk) W0 evaluated at (I, J, k), per-(k,a,b,c):
        #   W0[i,j,k] = t2[j,k,a,e] <ei||bc> - t2[i,m,b,c] <ma||jk>
        A = (einsum("kae,ebc->kabc", t2J, vovvI)
             - einsum("mbc,mak->kabc", t2I, ovooJ))
        B = (einsum("kae,ebc->kabc", t2I, vovvJ)
             - einsum("mbc,mak->kabc", t2J, ovooI))
        C = (einsum("ae,ekbc->kabc", t2J[I], vovv)
             - einsum("kmbc,ma->kabc", t2, ovoo[:, :, J, I]))
        w = pabc(A - B - C)
        # P(i/jk) [t1_ia <jk||bc>] at (I, J, k)
        v0 = (einsum("a,kbc->kabc", t1[I], oovv[J])
              - einsum("a,kbc->kabc", t1[J], oovv[I])
              - einsum("ka,bc->kabc", t1, oovv[J, I]))
        v = pabc(v0)
        D = fo[I] + fo[J] + Dk
        return acc + jnp.sum(w * (w + v) / D), None

    acc, _ = jax.lax.scan(body, jnp.asarray(0.0, t1.dtype),
                          jnp.arange(nocc * nocc))
    return acc / 36.0


def _update_map_and_energy(eris, tvec, fvec, nocc, nvir, with_t=True,
                           vvvv_op=None, sect=None):
    """The SCF update map G(t; f) (flattened) and E = E_CCSD (+ E_T).

    The fixed point t* = G(t*, f) defines the amplitudes; using the MAP (not
    the residual) keeps the implicit-function Jacobian (I - dG/dt)
    nonsingular: the residual form has a singular Jacobian because the t2
    antisymmetry makes its constraint rows redundant.

    vvvv_op: optional non-dense ladder operand (pack-on-build ERIs).  Safe
    under the adjoint solve: the packed map agrees with the dense one on
    antisymmetric t2 and both maps' t2 outputs are antisymmetric by
    construction, so they share the same fixed-point branch t*(f) — the
    implicit gradient is identical.

    sect: optional (SectorInfo, sym) — run the SECTOR-BLOCKED update map
    (ops/ccsd_sect.tupdate_sect, sorted layout; ~6.4x fewer FLOPs in every
    adjoint matvec).  Exact for the implicit gradient: at a balanced
    amplitude point the dense Jacobian's (balanced-out, off-balance-in)
    blocks vanish by spin conservation, so the balanced-subspace adjoint
    iterates never couple to what the sectored map drops; any valid
    fixed-point map of the same branch t*(f) yields the same gamma.  The
    map always runs sym=False (its folded-gradient variant is only valid
    for values, not the vjps this function exists for — see
    energy_t_sect's docstring for the energy-side fix)."""
    dim = nocc + nvir
    f = fvec.reshape(dim, dim)
    n1 = nocc * nvir
    t1 = tvec[:n1].reshape(nocc, nvir)
    t2 = tvec[n1:].reshape(nocc, nocc, nvir, nvir)
    if sect is not None:
        from ecw_cc_tpu.ops.ccsd_sect import tupdate_sect

        G1, G2 = tupdate_sect(eris, t1, t2, f, sect[0], vvvv_op=vvvv_op)
    else:
        G1, G2 = ccsd_ops.tupdate(eris, t1, t2, fsp=f, vvvv_op=vvvv_op)
    E = ccsd_ops.energy(eris, t1, t2, f)
    if with_t:
        E = E + energy_t(eris, t1, t2, f, sect=sect)
    return jnp.concatenate([G1.ravel(), G2.ravel()]), E


def ccsd_t_rdm1_response(eris, t1, t2, fsp=None, with_t=True, tol=1e-10,
                         maxiter=300, vvvv_op=None, sect=None):
    """Unrelaxed response density of E_CCSD(+T) in the MO G basis (with the
    HF diagonal added), via adjoint implicit differentiation of the SCF
    fixed-point map:
        (I - dG/dt)^T w = dE/dt   (fixed-point iteration + DIIS)
        gamma = dE/df + w^T dG/df

    sect: optional (SectorInfo, sym) routing the (T) energy through the
    sector-blocked scans (sorted layout).  EXACT for the gradient too: the
    sectored E only drops t-derivative components on structurally-zero
    (off-balance) blocks, and those components of the true dE/dt vanish at
    a balanced amplitude point by spin conservation (every (T) term chains
    spin-balanced eris blocks, so a single off-balance derivative index
    cannot be completed to a surviving spin assignment); the f-derivative
    of (T) enters only through diag(f), which sectoring never touches.
    Verified against the dense path in tests/test_ccsd_t.py."""
    nocc, nvir = t1.shape
    dim = nocc + nvir
    f0 = (eris.fock if fsp is None else fsp).ravel()
    tvec = jnp.concatenate([jnp.ravel(t1), jnp.ravel(t2)])
    if sect is not None:
        from ecw_cc_tpu.ops import ladder

        vvvv_op = ladder.ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])

    # all jitted pieces take eris/tvec/f0 as ARGUMENTS (closure-captured
    # device arrays become constants baked into the program); the
    # linearization happens inside the jit, traced once per compile
    @partial(jax.jit, static_argnames=("wt",))
    def grad_E(er, vs, tv, fv, wt):
        gE_t = jax.grad(lambda a, b: _update_map_and_energy(
            er, a, b, nocc, nvir, wt, vs, sect)[1], argnums=0)(tv, fv)
        gE_f = jax.grad(lambda a, b: _update_map_and_energy(
            er, a, b, nocc, nvir, wt, vs, sect)[1], argnums=1)(tv, fv)
        return gE_t, gE_f

    @partial(jax.jit, static_argnames=("wt",))
    def matvec_t(er, vs, tv, fv, v, wt):
        _, vjp = jax.vjp(lambda a: _update_map_and_energy(
            er, a, fv, nocc, nvir, wt, vs, sect)[0], tv)
        return vjp(v)[0]

    @partial(jax.jit, static_argnames=("wt",))
    def vjp_fock(er, vs, tv, fv, v, wt):
        _, vjp = jax.vjp(lambda b: _update_map_and_energy(
            er, tv, b, nocc, nvir, wt, vs, sect)[0], fv)
        return vjp(v)[0]

    dE_dt, dE_df = grad_E(eris, vvvv_op, tvec, f0, with_t)

    # w = dE/dt + (dG/dt)^T w  — same contraction structure as the Lambda
    # equations; fixed-point iteration with ON-DEVICE DIIS (only the norm
    # scalar crosses to the host per iteration)
    from ecw_cc_tpu.ops import diis as diis_ops

    @jax.jit
    def _w_step(er, vs, tv, fv, b, w, dstate):
        # b (= dE/dt) as an ARGUMENT: a closure would bake a multi-MB
        # constant into the program shipped to the remote compiler
        w_new = b + matvec_t(er, vs, tv, fv, w, with_t)
        nrm = jnp.linalg.norm(w_new - w)
        dstate, w_d = diis_ops.diis_update(dstate, w_new, 2)
        return w_new, w_d, dstate, nrm

    w = dE_dt
    dstate = diis_ops.diis_init(w.size, space=10, dtype=w.dtype)
    for _ in range(maxiter):
        w_new, w_d, dstate, nrm = _w_step(eris, vvvv_op, tvec, f0, dE_dt, w,
                                          dstate)
        if float(nrm) < tol:
            w = w_new
            break
        w = w_d

    # gamma = dE/df + w^T dG/df
    gamma = (dE_df + vjp_fock(eris, vvvv_op, tvec, f0, w,
                              with_t)).reshape(dim, dim)
    hf = jnp.diag(jnp.concatenate([jnp.ones(nocc, gamma.dtype),
                                   jnp.zeros(nvir, gamma.dtype)]))
    return gamma + hf


@partial(jax.jit, static_argnames=("use_sectors", "sect"))
def _ccsd_diis_step(eris, vvsect, t1, t2, dstate, use_sectors=False,
                    sect=None):
    """Jacobi step + ON-DEVICE DIIS in one program: only the energy scalar
    crosses to the host per iteration (a host-DIIS round trip would copy
    t2 both ways every iteration).

    sect: optional (SectorInfo, sym) — sector-blocked update kernels
    (sorted layout; ops/ccsd_sect.py).  A pure value iteration, so the sym
    (mirror-halved) kernels are usable directly."""
    from ecw_cc_tpu.ops import diis as diis_ops

    vop = vvsect if use_sectors else None
    if sect is not None:
        from ecw_cc_tpu.ops.ccsd_sect import tupdate_sect

        t1n, t2n = tupdate_sect(eris, t1, t2, eris.fock, sect[0],
                                vvvv_op=vop, sym=sect[1])
    else:
        t1n, t2n = ccsd_ops.tupdate(eris, t1, t2, None, vvvv_op=vop)
    e_cc = ccsd_ops.energy(eris, t1n, t2n, None)
    nocc, nvir = t1n.shape
    n1 = nocc * nvir
    dstate, vec = diis_ops.diis_update(
        dstate, jnp.concatenate([t1n.ravel(), t2n.ravel()]), 2)
    t1d = vec[:n1].reshape(nocc, nvir)
    t2d = vec[n1:].reshape(nocc, nocc, nvir, nvir)
    return t1d, t2d, dstate, e_cc


def solve_ccsd(eris, conv_tol=1e-10, max_cycle=200, vvvv_op=None, sect=None):
    """Plain CCSD amplitudes (MP2 start, Jacobi iterations with DIIS).

    vvvv_op: prebuilt ladder operand (pack-on-build ERIs); default derives
    one from eris.vvvv per config.ladder_mode.
    sect: optional (SectorInfo, sym) — sector-blocked updates (sorted
    layout; requires a non-dense vvvv_op or a dense sorted eris.vvvv)."""
    from ecw_cc_tpu.ops import diis as diis_ops
    from ecw_cc_tpu.ops import ladder

    nocc, nvir = eris.nocc, eris.nvir
    if sect is not None:
        vvvv_op = ladder.ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])
    vvsect = ladder.make_vvvv_op(eris.vvvv) if vvvv_op is None else vvvv_op
    use_sectors = vvsect is not None
    e = jnp.diag(eris.fock)
    eia = e[:nocc, None] - e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t1 = jnp.zeros((nocc, nvir), dtype=eris.fock.dtype)
    t2 = eris.oovv / eijab
    dstate = diis_ops.diis_init(nocc * nvir + (nocc * nvir) ** 2, space=8,
                                dtype=t1.dtype)
    e_old = 0.0
    e_cc = 0.0
    for _ in range(max_cycle):
        t1, t2, dstate, e_dev = _ccsd_diis_step(eris, vvsect, t1, t2, dstate,
                                                use_sectors=use_sectors,
                                                sect=sect)
        e_cc = float(e_dev)
        if abs(e_cc - e_old) < conv_tol:
            break
        e_old = e_cc
    return t1, t2, e_cc
