"""Antisymmetrized spin-orbital ERIs in physicists' notation, as a device pytree.

Replaces reference Eris.py (geris class): the AO ERI tensor is transformed to
the GHF MO basis, antisymmetrized <pq||rs> = <pq|rs> - <pq|sr>, and sliced
into the 16 occ/vir blocks used by the CC kernels (Eris.py:132-150).  The
Fock matrix is diagonal in the canonical HF basis: fock = diag(mo_energy)
(Eris.py:132).

Design: GEris is a frozen NamedTuple-of-arrays pytree.  Each block
is staged once to the device; the CC kernels consume it inside jit.  Only the
blocks actually used are materialized (all 16 here — small systems; for large
nvir the vvvv block may be sharded along its first two axes, see
ecw_cc_tpu/parallel/sharding.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ecw_cc_tpu.config import get_config, setup_jax


class GEris(NamedTuple):
    """Antisymmetrized <pq||rs> blocks (physicists' notation), G spin-orbital basis."""
    fock: np.ndarray   # (nmo, nmo), diagonal of mo_energy
    oooo: np.ndarray
    ooov: np.ndarray
    oovo: np.ndarray
    oovv: np.ndarray
    ovov: np.ndarray
    ovvo: np.ndarray
    ovvv: np.ndarray
    ovoo: np.ndarray
    vvvv: np.ndarray
    vooo: np.ndarray
    vovo: np.ndarray
    voov: np.ndarray
    vovv: np.ndarray
    vvoo: np.ndarray
    vvvo: np.ndarray

    @property
    def nocc(self):
        return self.oooo.shape[0]

    @property
    def nvir(self):
        return self.vvvv.shape[0]


class ErisHost:
    """Host-side ERI builder + container mirroring the reference `geris` API
    (attributes .fock .oooo ... .nocc .mo_occ .EHF)."""

    def __init__(self, mol, ghf, int_thresh=1e-13, dir_cont=False):
        self.mol = mol
        self.ghf = ghf
        self.orbspin = ghf.orbspin
        nmo = ghf.mo_coeff.shape[1]
        nao = mol.nao
        nocc = int(np.sum(ghf.mo_occ > 0))

        eri_ao = mol.intor("int2e")
        mo_a = ghf.mo_coeff[:nao]
        mo_b = ghf.mo_coeff[nao:]
        if dir_cont:
            # direct contraction against the spin-blocked AO ERI with the
            # full G mo_coeff (reference Eris.py:58-94, dir_cont path)
            eri_g = np.zeros((2 * nao,) * 4)
            for sa in (0, 1):
                for sb in (0, 1):
                    eri_g[sa * nao:(sa + 1) * nao, sa * nao:(sa + 1) * nao,
                          sb * nao:(sb + 1) * nao, sb * nao:(sb + 1) * nao] = eri_ao
            mo = ghf.mo_coeff
            eri = np.einsum("pqrs,pi->iqrs", eri_g, mo, optimize=True)
            eri = np.einsum("iqrs,qj->ijrs", eri, mo, optimize=True)
            eri = np.einsum("ijrs,rk->ijks", eri, mo, optimize=True)
            eri = np.einsum("ijks,sl->ijkl", eri, mo, optimize=True)
        else:
            # AO ERI (chemists (ij|kl)) -> G-format MO (mo = mo_a + mo_b
            # summed rows, spin-forbidden elements zeroed; reference
            # Eris.py:108-120).  Quarter transforms run as explicit GEMMs
            # (contract the leading axis, cycle it to the back): ~300 GFLOP
            # in four dgemms instead of minutes of generic einsum.
            mo = np.ascontiguousarray(mo_a + mo_b)

            def quarter(t):
                n0 = t.shape[0]
                out = mo.T @ t.reshape(n0, -1)
                out = out.reshape((nmo,) + t.shape[1:])
                return np.ascontiguousarray(np.moveaxis(out, 0, -1))

            eri = eri_ao
            for _ in range(4):
                eri = quarter(eri)
            spin = self.orbspin
            forbid = spin[:, None] != spin[None, :]
            eri[forbid, :, :] = 0.0
            eri[:, :, forbid] = 0.0
        # chemists (pq|rs) -> physicists <pr|qs>, antisymmetrize
        eri = eri.transpose(0, 2, 1, 3) - eri.transpose(0, 2, 3, 1)
        if int_thresh:
            eri[np.abs(eri) < int_thresh] = 0.0

        o, v = slice(0, nocc), slice(nocc, nmo)
        self.fock = np.diag(ghf.mo_energy)
        self.oooo = eri[o, o, o, o].copy()
        self.ooov = eri[o, o, o, v].copy()
        self.oovo = eri[o, o, v, o].copy()
        self.oovv = eri[o, o, v, v].copy()
        self.ovov = eri[o, v, o, v].copy()
        self.ovvo = eri[o, v, v, o].copy()
        self.ovvv = eri[o, v, v, v].copy()
        self.ovoo = eri[o, v, o, o].copy()
        self.vvvv = eri[v, v, v, v].copy()
        self.vooo = eri[v, o, o, o].copy()
        self.vovo = eri[v, o, v, o].copy()
        self.voov = eri[v, o, o, v].copy()
        self.vovv = eri[v, o, v, v].copy()
        self.vvoo = eri[v, v, o, o].copy()
        self.vvvo = eri[v, v, v, o].copy()
        self.nocc = nocc
        self.nvir = nmo - nocc
        self.mo_occ = ghf.mo_occ
        self.mo_energy = ghf.mo_energy
        self.mo_coeff = ghf.mo_coeff
        self.EHF = ghf.e_tot
        del eri

    def to_device(self, dtype=None, sharding=None) -> GEris:
        """Stage the blocks as a jax pytree (optionally sharded)."""
        import jax
        import jax.numpy as jnp

        setup_jax()
        dtype = dtype or get_config().dtype
        fields = {}
        for name in GEris._fields:
            arr = jnp.asarray(getattr(self, name), dtype=dtype)
            if sharding is not None and name in sharding:
                arr = jax.device_put(arr, sharding[name])
            fields[name] = arr
        return GEris(**fields)


def build_eris(mol, ghf, int_thresh=1e-13, dir_cont=False):
    return ErisHost(mol, ghf, int_thresh=int_thresh, dir_cont=dir_cont)


def _packed_rows_from_slab(slab4, eff, lo, hi):
    """Packed ladder rows from one physicists <ab||ef> slab (w, v, v, v)
    whose first axis covers a = eff..eff+w-1 (eff <= lo; the last slab is
    start-clamped so it may overlap its predecessor): keep rows (a, b) with
    lo <= a < hi and b > a, and pack the (e, f) columns to e < f — the rows
    of PackedVVVV.wc for this a-range (pair rows with a fixed leading a are
    contiguous in row-major a<b pair order).  eff/lo/hi must be static (row
    slicing is shape-determining)."""
    import jax.numpy as jnp

    from ecw_cc_tpu.ops.ladder import _pack_pairs

    v = slab4.shape[1]
    rows = [slab4[a - eff, a + 1:].reshape(v - a - 1, v * v)
            for a in range(lo, hi) if a + 1 < v]
    if not rows:                      # slab holding only a = v-1
        return jnp.zeros((0, v * (v - 1) // 2), slab4.dtype)
    return _pack_pairs(jnp.concatenate(rows, axis=0), v)


def permute_geris(eris: GEris, o_idx, v_idx, f_idx) -> GEris:
    """Apply occ/vir index maps (output_index -> input_index) to every block
    of a GEris (device gathers; one-time relayout).  f_idx is the combined
    map for the (dim, dim) fock.  Used to derive an alternating-layout view
    from a spin-sorted build (for consumers without sorted-layout support);
    a zero-size vvvv placeholder is passed through."""
    import jax.numpy as jnp

    o_idx = jnp.asarray(o_idx)
    v_idx = jnp.asarray(v_idx)
    f_idx = jnp.asarray(f_idx)
    fields = {}
    for name in GEris._fields:
        arr = getattr(eris, name)
        if name == "fock":
            fields[name] = arr[f_idx][:, f_idx]
            continue
        if arr.size == 0:
            fields[name] = arr
            continue
        for ax, kind in enumerate(name):
            arr = jnp.take(arr, o_idx if kind == "o" else v_idx, axis=ax)
        fields[name] = arr
    return GEris(**fields)


def warn_if_sorted_layout(eris, where):
    """Warn when an eris handle that must be in the reference (alternating
    alpha/beta) MO convention looks spin-SORTED instead.

    Under the f32 production config ECW builds spin-sorted eris
    (config.spin_sorted); consumers without sorted-layout support must use
    ECW._eris_alt().  Feeding the sorted handle silently scrambles the
    physics: the r4 'f32 ES instability' (7.13 -> 9.11 eV drift) was
    exactly this — alternating-convention amplitudes
    iterated against sorted blocks (diagnosed tools/es_f32_drift_r5.py).

    Detection is structural, on the fock diagonal of an (RHF-derived) GHF,
    checked separately on the occ and vir segments (the sorted layout
    sorts each segment alpha-block-first): alternating has equal PAIRS
    d[0::2] == d[1::2]; sorted has equal HALVES d[:m/2] == d[m/2:].  Warn
    only when the pairs test fails and the halves test passes on both
    segments (a UHF-derived GHF fails both)."""
    d = np.diag(np.asarray(eris.fock))
    no = eris.oovv.shape[0]
    segs = [d[:no], d[no:]]
    if any(s.size < 2 or s.size % 2 for s in segs):
        return
    tol = 1e3 * np.finfo(d.dtype).eps * max(1.0, float(np.abs(d).max()))
    pairs = all(np.allclose(s[0::2], s[1::2], atol=tol) for s in segs)
    halves = all(np.allclose(s[:s.size // 2], s[s.size // 2:], atol=tol)
                 for s in segs)
    if halves and not pairs:
        import warnings

        warnings.warn(
            f"{where}: the eris fock diagonal looks spin-SORTED "
            "(alpha block then beta block), but this consumer expects the "
            "reference alternating convention — pass ECW._eris_alt() (or "
            "a host-built eris) instead of the sorted production handle",
            RuntimeWarning, stacklevel=3)


def _sector_rows_from_slab(slab4, eff, lo, hi, ma):
    """Sectored ladder rows from one sorted-layout <ab||ef> slab (w, v, v, v)
    covering a = eff..eff+w-1 (cf. _packed_rows_from_slab): returns
    (aa_rows, ab_rows, bb_rows) — the wc_aa / w_ab / wc_bb row groups of
    ops/ladder.SectoredVVVV for lo <= a < hi.  In the sorted layout every
    sector slice is contiguous; spin-forbidden blocks are never read."""
    import jax.numpy as jnp

    from ecw_cc_tpu.ops.ladder import _pack_pairs

    v = slab4.shape[1]
    mb = v - ma
    aa, ab, bb = [], [], []
    for a in range(lo, hi):
        row = slab4[a - eff]
        if a < ma:
            if a + 1 < ma:
                aa.append(row[a + 1:ma, :ma, :ma].reshape(ma - a - 1, ma * ma))
            ab.append(row[ma:, :ma, ma:].reshape(mb, ma * mb))
        elif a + 1 < v:
            bb.append(row[a + 1:, ma:, ma:].reshape(v - a - 1, mb * mb))

    def cat(rows, pack_m, ncols):
        if not rows:
            return jnp.zeros((0, ncols), slab4.dtype)
        out = jnp.concatenate(rows, axis=0)
        return _pack_pairs(out, pack_m) if pack_m else out

    return (cat(aa, ma, ma * (ma - 1) // 2),
            cat(ab, 0, ma * mb),
            cat(bb, mb, mb * (mb - 1) // 2))


def build_eris_device(mol, ghf, dtype="float32", pack_ladder=False,
                      sort_spin=False):
    """Build the G-format antisymmetrized ERI blocks ON the device.

    sort_spin=True permutes the MO order by spin WITHIN the occupied and
    virtual blocks (alpha first; ops/ladder.spin_sort_perm) BEFORE the
    transform, so every block comes out in the spin-SORTED layout where
    sector slices are contiguous.  With pack_ladder=True the ladder operand
    is then the block-diagonal SectoredVVVV (2.67x fewer ladder FLOPs and
    2.67x less wc HBM than PackedVVVV; ops/ladder.py).  Consumers must run
    amplitudes in the sorted convention and permute rdm1/targets at the
    host boundary (Solver_CCSD(mo_perm=...) does); the permutation is
    recomputable as spin_sort_perm(ghf.orbspin, nocc).

    pack_ladder=True never materializes the dense (v,v,v,v) block: each
    transform slab is reduced straight to its antisymmetry-packed ladder
    rows (ops/ladder.PackedVVVV), the GEris carries a (nvir,0,0,0)
    placeholder for vvvv (shape keeps .nvir working), and the return value
    becomes a (GEris, PackedVVVV) pair.  Cuts the biggest block 4x in
    steady-state HBM (2.75 GB -> 0.68 GB at C2H2/cc-pVTZ) and avoids the
    dense-slab concat peak; requires every consumer to run the packed
    ladder route (the ECW driver and bench thread the op into the CCSD
    solvers; paths needing dense vvvv must build with pack_ladder=False).

    The AO ERI tensor is staged once; the quarter transforms (~nmo^5 FLOPs),
    spin masking, antisymmetrization and block slicing all run as jitted XLA
    programs on the accelerator — seconds instead of minutes of
    host-bandwidth-bound NumPy at large bases (the host path in ErisHost
    remains the parity oracle).

    PRECISION: a DIRECT f32 AO->MO transform catastrophically cancels for
    ill-conditioned (diffuse) bases — at C2H2/6-311++G(2d,2p) the MO
    coefficients reach ~1e2 (cond(S) ~ 1e4) and the f32-summed oovv came out
    orders of magnitude wrong, diverging CCSD.  The transform is therefore
    COMPENSATED by splitting it through the orthonormalized AO basis,

        mo = X U,   X = S^{-1/2}  (carries ALL the ill-conditioning),
                    U = S^{1/2} mo  (exactly orthonormal columns, |U| <= 1),

    and running the X half on the HOST in f64 (nao-dimensional spatial
    dgemm quarters, ~20 GFLOP at nao=74 — about a second of BLAS; this is
    NOT the old ~2 min G-format host fallback, which worked in the doubled
    148-dim basis).  The orthonormal-basis AO tensor is then rounded to f32
    (pure representation error, no cancellation left to amplify), uploaded
    (same bytes as the AO tensor upload the all-device path paid), and the
    benign U half + block slicing/packing run on device as before.  Block
    accuracy is ~1e-6 relative for ANY realistic cond(S): measured 2e-6
    max-abs at C2H2/6-311++G(2d,2p) (cond(S)=7.5e5), where the previous
    all-f32 two-stage scheme produced O(10x) errors and CCSD diverged.
    The cond(S)-gated host-f64 fallback (r2) is gone — nothing to fall
    back to.
    """
    import jax
    import jax.numpy as jnp

    from ecw_cc_tpu.config import setup_jax

    setup_jax()
    nao = mol.nao
    nmo = ghf.mo_coeff.shape[1]
    nocc = int(np.sum(ghf.mo_occ > 0))
    S = mol.intor("ovlp")
    w, V = np.linalg.eigh(S)
    mo_np = np.asarray(ghf.mo_coeff[:nao] + ghf.mo_coeff[nao:],
                       dtype=np.float64)
    spin_host = np.asarray(ghf.orbspin)
    mo_energy = np.asarray(ghf.mo_energy)
    ma = 0
    if sort_spin:
        from ecw_cc_tpu.ops.ladder import spin_sort_perm

        perm = spin_sort_perm(spin_host, nocc)
        mo_np = np.ascontiguousarray(mo_np[:, perm])
        spin_host = spin_host[perm]
        mo_energy = mo_energy[perm]
        ma = int(np.sum(spin_host[nocc:] == 0))   # alpha virtuals (sorted first)
    Xh = (V * (w ** -0.5)) @ V.T           # S^{-1/2}
    U = ((V * (w ** 0.5)) @ V.T) @ mo_np   # S^{1/2} mo, orthonormal columns

    # X half on host, f64 (exact where cancellation lives).  Each quarter is
    # ONE dgemm whose output is already in cycled-contiguous order — the
    # moveaxis+reshape formulation paid a 240 MB strided copy per stage.
    Corth = mol.intor("int2e")
    for _ in range(4):
        n = Corth.shape[0]
        Corth = np.ascontiguousarray(
            Corth.reshape(n, -1).T @ Xh).reshape(
                Corth.shape[1:] + (nao,))
    # Host-to-device bytes: upload
    # only the 8-fold-symmetric unique elements (the symmetric-X transform
    # preserves (pq|rs) permutational symmetry), npair(npair+1)/2 floats
    # instead of nao^4 — 7.8x fewer bytes — and unpack on device with two
    # row-gathers.
    npair = nao * (nao + 1) // 2
    tu = np.asarray([p * nao + q for p in range(nao) for q in range(p + 1)])
    Mp_host = Corth.reshape(nao * nao, nao * nao)[np.ix_(tu, tu)]
    v_packed = jnp.asarray(Mp_host[np.tril_indices(npair)], dtype=dtype)
    del Corth, Mp_host

    p_ar = np.arange(nao)
    pq_host = np.where(
        p_ar[:, None] >= p_ar[None, :],
        p_ar[:, None] * (p_ar[:, None] + 1) // 2 + p_ar[None, :],
        p_ar[None, :] * (p_ar[None, :] + 1) // 2 + p_ar[:, None],
    ).reshape(-1)
    pq_idx = jnp.asarray(pq_host, dtype=jnp.int32)

    @jax.jit
    def unpack(v):
        x = jnp.arange(npair, dtype=jnp.int32)
        T = jnp.where(x[:, None] >= x[None, :],
                      x[:, None] * (x[:, None] + 1) // 2 + x[None, :],
                      x[None, :] * (x[None, :] + 1) // 2 + x[:, None])
        Mp = v[T]                                   # (npair, npair)
        M = jnp.take(jnp.take(Mp, pq_idx, 0), pq_idx, 1)
        return M.reshape(nao, nao, nao, nao)

    C = unpack(v_packed)
    del v_packed

    spin = spin_host
    allow = jnp.asarray((spin[:, None] == spin[None, :]), dtype=dtype)
    fock = jnp.asarray(np.diag(mo_energy), dtype=dtype)

    # Memory-lean staging: each quarter transform is its own program (peak =
    # in + out, freed between stages); physicists' blocks are sliced straight
    # from the chemists MO tensor without materializing the full <pq||rs>:
    # <pq||rs> = (pr|qs) - (ps|qr).  The spin mask is applied per block.
    @jax.jit
    def quarter(mat, t):
        return jnp.moveaxis(
            (mat.T @ t.reshape(t.shape[0], -1)).reshape(
                (mat.shape[1],) + t.shape[1:]), 0, 3)

    # U half on device (orthonormal columns: no amplification in f32)
    U_dev = jnp.asarray(U, dtype=dtype)
    for _ in range(4):
        C = quarter(U_dev, C)
        C.block_until_ready()

    o, v = slice(0, nocc), slice(nocc, nmo)
    sl = {"o": o, "v": v}
    nvir = nmo - nocc
    names = ["oooo", "ooov", "oovo", "oovv", "ovov", "ovvo", "ovvv",
             "ovoo", "vooo", "vovo", "voov", "vovv", "vvoo", "vvvo"]

    def block_mask(a0, a1, a2, a3):
        # indices in TENSOR AXIS ORDER of a chemists slice (e1 pair =
        # axes 0,1; e2 pair = axes 2,3): allowed iff spin(axis0)==
        # spin(axis1) and spin(axis2)==spin(axis3)
        return (allow[sl[a0], :][:, sl[a1]][:, :, None, None]
                * allow[sl[a2], :][:, sl[a3]][None, None, :, :])

    # ONE PROGRAM PER BLOCK: the r2 merged 14-block program hit a
    # pathological XLA compile at the flagship shape (nmo=148: >9 min in
    # .compile(), measured r3), while per-block programs compile in ~1 s
    # each and cache individually in the persistent compile cache.
    from functools import partial

    @partial(jax.jit, static_argnums=(1,))
    def one_block(C, name):
        p, q, r, s = name
        t1 = (C[sl[p]][:, sl[r]][:, :, sl[q]][:, :, :, sl[s]]
              * block_mask(p, r, q, s))           # (p,r,q,s)
        t2 = (C[sl[p]][:, sl[s]][:, :, sl[q]][:, :, :, sl[r]]
              * block_mask(p, s, q, r))           # (p,s,q,r)
        return (jnp.transpose(t1, (0, 2, 1, 3))
                - jnp.transpose(t2, (0, 2, 3, 1))).astype(dtype)

    blocks = {}
    for name in names:
        blocks[name] = one_block(C, name)
        blocks[name].block_until_ready()

    # vvvv in fixed-width slabs over the first virtual index: bounds the
    # transient slice/transpose buffers AND compiles one slab program reused
    # for every chunk.  width = ceil(nvir/6); the last slab's start is
    # CLAMPED by dynamic_slice (for non-divisible nvir it overlaps its
    # predecessor and the duplicate rows are sliced off) — a
    # divisor-of-nvir scheme degenerated to width 2 for near-prime nvir
    # (67 slab dispatches, and 67 distinct pack programs at 6-311++G(2d,2p)).
    width = max(1, -(-nvir // 6))
    starts = list(range(0, nvir, width))
    allow_vv = allow[v, :][:, v]

    @jax.jit
    def slab(C, lo):
        piece = jax.lax.dynamic_slice_in_dim(C, nocc + lo, width, axis=0)
        t1 = piece[:, v][:, :, v][:, :, :, v]  # chemists (a,e,b,f)
        m_ae = jax.lax.dynamic_slice_in_dim(allow_vv, lo, width, axis=0)
        t1 = t1 * (m_ae[:, :, None, None] * allow_vv[None, None, :, :])
        return (jnp.transpose(t1, (0, 2, 1, 3))
                - jnp.transpose(t1, (0, 2, 3, 1))).astype(dtype)

    if pack_ladder and sort_spin:
        from ecw_cc_tpu.ops.ladder import SectoredVVVV

        extract = jax.jit(_sector_rows_from_slab, static_argnums=(1, 2, 3, 4))
        groups = ([], [], [])
        for lo in starts:
            eff = min(lo, nvir - width)     # dynamic_slice clamp, made static
            part = slab(C, lo)
            rows = extract(part, eff, lo, min(lo + width, nvir), ma)
            for g, r in zip(groups, rows):
                r.block_until_ready()
                g.append(r)
            del part
        wc_aa, w_ab, wc_bb = (jnp.concatenate(g, axis=0) for g in groups)
        wc_bb.block_until_ready()
        del groups
        blocks["vvvv"] = jnp.zeros((nvir, 0, 0, 0), dtype)
        blocks["fock"] = fock
        return GEris(**blocks), SectoredVVVV(wc_aa=wc_aa, wc_bb=wc_bb,
                                             w_ab=w_ab)

    if pack_ladder:
        from ecw_cc_tpu.ops.ladder import PackedVVVV

        extract = jax.jit(_packed_rows_from_slab, static_argnums=(1, 2, 3))
        prows = []
        for lo in starts:
            eff = min(lo, nvir - width)     # dynamic_slice clamp, made static
            part = slab(C, lo)
            prows.append(extract(part, eff, lo, min(lo + width, nvir)))
            prows[-1].block_until_ready()
            del part
        wc = jnp.concatenate(prows, axis=0)
        wc.block_until_ready()
        del prows
        blocks["vvvv"] = jnp.zeros((nvir, 0, 0, 0), dtype)
        blocks["fock"] = fock
        return GEris(**blocks), PackedVVVV(wc=wc)

    parts = []
    for lo in starts:
        eff = min(lo, nvir - width)
        part = slab(C, lo)
        part.block_until_ready()
        parts.append(part if eff == lo else part[lo - eff:])
    blocks["vvvv"] = jnp.concatenate(parts, axis=0)
    blocks["vvvv"].block_until_ready()
    blocks["fock"] = fock
    return GEris(**blocks)
