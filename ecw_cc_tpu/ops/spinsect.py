"""Spin-sector-blocked einsum for the SORTED MO layout (o^3 v^3 soup terms).

Every G-format tensor in this framework that descends from a spin-free
Hamiltonian and an RHF-derived GHF reference is spin-block sparse: an
element is nonzero only when the spin multiset of its "bra" index half
equals that of its "ket" half (<pq||rs>: {s_p,s_q}={s_r,s_s}, reference
Eris.py:57 orbspin convention; amplitudes t2[ijab]: {s_i,s_j}={s_a,s_b};
t1[ia]: s_i=s_a).  Only 6 of 16 spin blocks of a 4-index tensor are
nonzero.

In the spin-SORTED layout (ops/ladder.spin_sort_perm: alpha first within
occ and vir) every spin block is a CONTIGUOUS sub-slice, so a contraction
of such tensors decomposes into a few dense sub-block contractions with
no gathers.  Because per-index spin assignments must be consistent across
ALL operands, the contraction sectors are constrained and the output
inherits its own sparsity: for the o^3 v^3 "soup" terms (t2 x oovv
family) the FLOP count drops to 10/64 ~ 15.6% of the dense-layout GEMM
and the operand reads to ~37.5%.  Exact dead-FLOP elimination, not an
approximation.

Design: `SpinBlocked` carries {spin-key: sub-array} with NO dense
materialization, so chains of sectored contractions never write the
structurally-zero blocks at all; `sector_einsum` enumerates the
compatible assignments at TRACE time (host combinatorics, static under
jit) and emits one small einsum per survivor.  Intermediates carry their
TRUE support (the set of produced keys), so no balance assumption is ever
applied to a derived tensor.

Validity: exact when every primitive operand really has its assumed
support — eris blocks and amplitudes do PROVIDED the Vexp potential is
spin-block-diagonal (the solver checks the targets once at build time,
ops/vexp.make_gs_vexp_device targets; all RHF-derived 'mat' targets are
block-diagonal) — see is_block_diagonal.

SPIN-FLIP SYMMETRY (closed shell): for an RHF-derived GHF reference with
spin-restricted operators, the global alpha<->beta flip maps every MO to
its spatial twin, so each spin block EQUALS the block at the flipped key
at the same spatial indices — the same array, no transpose (e.g.
t2[i_b j_a a_b b_a] block == t2[i_a j_b a_a b_b] block).  `sym=True`
SpinBlocked tensors store only one canonical block per mirror pair and
`sector_einsum` skips the mirrored output blocks entirely — an exact
further 2x FLOP cut on every contraction (the mirror blocks are assembled
by reference in .dense()).  Validity gate: alpha/beta sector sizes equal
AND every primitive operand numerically flip-symmetric (solver checks
eris + Vexp targets once at build; see spin_flip_asymmetry /
is_spin_restricted).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SectorInfo(NamedTuple):
    """Alpha/beta block sizes of the sorted layout (alpha first)."""
    oa: int
    ob: int
    va: int
    vb: int

    @property
    def nocc(self):
        return self.oa + self.ob

    @property
    def nvir(self):
        return self.va + self.vb


def sector_info(orbspin_sorted, nocc) -> SectorInfo:
    import numpy as np

    s = np.asarray(orbspin_sorted)
    return SectorInfo(int(np.sum(s[:nocc] == 0)), int(np.sum(s[:nocc] == 1)),
                      int(np.sum(s[nocc:] == 0)), int(np.sum(s[nocc:] == 1)))


def _slices(info):
    return {
        ("o", 0): slice(0, info.oa), ("o", 1): slice(info.oa, info.nocc),
        ("v", 0): slice(0, info.va), ("v", 1): slice(info.va, info.nvir),
    }


def _balanced(spins):
    """Balanced-halves spin rule: the multiset of the first half equals
    that of the second (s0==s1 for 2 indices; {s0,s1}=={s2,s3} for 4 —
    the <pq||rs> / amplitude rule)."""
    h = len(spins) // 2
    return sorted(spins[:h]) == sorted(spins[h:])


def _flip(key):
    """The global alpha<->beta mirror of a spin key."""
    return tuple(1 - s for s in key)


def _is_canon(key):
    """Canonical representative of a mirror pair (key != flip(key) always,
    every flip changes every bit; the empty key is its own canon)."""
    return key <= _flip(key)


class SpinBlocked:
    """A spin-sector-blocked tensor in the sorted layout.

    kinds: 'o'/'v' per axis; blocks: {key: sub-array} with key a tuple of
    0 (alpha) / 1 (beta) per axis — ONLY the nonzero blocks are stored.

    sym=True (closed-shell spin-flip symmetry): only the canonical block
    of each mirror pair is stored; `get(flip(key))` returns the SAME array
    (equal content at equal spatial indices — no transpose involved)."""

    __slots__ = ("kinds", "blocks", "info", "sym")

    def __init__(self, kinds, blocks, info, sym=False):
        self.kinds = kinds
        self.blocks = blocks
        self.info = info
        self.sym = sym

    def get(self, key):
        """The block at `key`, honoring the mirror identity when sym."""
        val = self.blocks.get(key)
        if val is None and self.sym:
            val = self.blocks.get(_flip(key))
        return val

    @classmethod
    def from_dense(cls, arr, kinds, info, support=None, sym=False):
        """Slice the nonzero blocks out of a dense sorted-layout array.
        support: iterable of keys (default: all balanced-halves keys).
        sym: store only the canonical half (the mirrored content of `arr`
        is TRUSTED equal and never read)."""
        sl = _slices(info)
        if support is None:
            support = [k for k in itertools.product((0, 1), repeat=len(kinds))
                       if _balanced(k)]
        if sym:
            support = sorted({k if _is_canon(k) else _flip(k)
                              for k in support})
        blocks = {}
        for key in support:
            idx = tuple(sl[(kind, s)] for kind, s in zip(kinds, key))
            sub = arr[idx]
            if sub.size:
                blocks[key] = sub
        return cls(kinds, blocks, info, sym=sym)

    def dense(self, dtype=None):
        """Assemble the dense sorted-layout array (zeros elsewhere; sym
        tensors write each canonical block at its mirror key too)."""
        info = self.info
        dim_of = {"o": info.nocc, "v": info.nvir}
        shape = tuple(dim_of[k] for k in self.kinds)
        some = next(iter(self.blocks.values()), None)
        res = jnp.zeros(shape, dtype or (some.dtype if some is not None
                                         else jnp.float32))
        sl = _slices(info)
        for key, val in self.blocks.items():
            keys = (key,) if not self.sym or _flip(key) == key \
                else (key, _flip(key))
            for k2 in keys:
                idx = tuple(sl[(k, s)] for k, s in zip(self.kinds, k2))
                res = res.at[idx].set(val.astype(res.dtype))
        return res

    def scale(self, c):
        return SpinBlocked(self.kinds,
                           {k: c * v for k, v in self.blocks.items()},
                           self.info, sym=self.sym)

    def __add__(self, other):
        assert self.kinds == other.kinds
        assert self.sym == other.sym, (
            "mixed sym/non-sym SpinBlocked addition is ambiguous; wrap "
            "both operands with the same sym flag")
        blocks = dict(self.blocks)
        for k, v in other.blocks.items():
            blocks[k] = blocks[k] + v if k in blocks else v
        return SpinBlocked(self.kinds, blocks, self.info, sym=self.sym)

    def transpose(self, *perm):
        kinds = "".join(self.kinds[p] for p in perm)
        blocks = {}
        for k, v in self.blocks.items():
            key = tuple(k[p] for p in perm)
            if self.sym and not _is_canon(key):
                key = _flip(key)   # same content lives at the mirror key
            blocks[key] = jnp.transpose(v, perm)
        return SpinBlocked(kinds, blocks, self.info, sym=self.sym)


def wrap(arr, kinds, info, sym=False):
    """SpinBlocked view of a primitive (balanced-halves) sorted tensor."""
    return SpinBlocked.from_dense(arr, kinds, info, sym=sym)


def mirror_dense(arr, kinds, info):
    """The global alpha<->beta mirror M of a dense sorted-layout tensor
    (requires equal sector sizes): swaps the alpha and beta slabs along
    every axis.  M is an involution; a tensor is closed-shell
    mirror-symmetric iff M(arr) == arr."""
    assert info.oa == info.ob and info.va == info.vb
    po = jnp.concatenate([jnp.arange(info.oa, info.nocc),
                          jnp.arange(0, info.oa)])
    pv = jnp.concatenate([jnp.arange(info.va, info.nvir),
                          jnp.arange(0, info.va)])
    for ax, k in enumerate(kinds):
        arr = jnp.take(arr, po if k == "o" else pv, axis=ax)
    return arr


def sliced_support(kinds_full, fixed):
    """Support of a balanced-halves tensor after FIXING some axes at known
    spins — e.g. a t2[J] slab inside a scan whose occupied row J lives in a
    known spin sector (the sectored (T) kernel, ops/ccsd_t.py): the
    remaining axes' keys are exactly those completing a balanced full key.

    kinds_full: kinds string of the FULL tensor ('oovv', ...)
    fixed: {axis_index: spin} of the sliced-away axes
    Returns (kinds_remaining, [keys]) for the remaining axes in order."""
    n = len(kinds_full)
    rem = [a for a in range(n) if a not in fixed]
    support = []
    for combo in itertools.product((0, 1), repeat=len(rem)):
        full = [0] * n
        for a, s in fixed.items():
            full[a] = s
        for a, s in zip(rem, combo):
            full[a] = s
        if _balanced(tuple(full)):
            support.append(combo)
    return "".join(kinds_full[a] for a in rem), support


def sector_einsum(spec, *operands, info=None):
    """einsum over SpinBlocked operands -> SpinBlocked output.

    Enumerates per-letter spin assignments compatible with every operand's
    stored support; emits one dense sub-einsum per survivor and sums into
    output blocks.  Static combinatorics; exact.

    When EVERY operand is sym (closed-shell mirror symmetry), the output
    is too: mirrored output keys are skipped entirely (their content
    equals the canonical block) — half the sub-einsums.  A scalar output
    instead keeps one representative of each mirrored assignment pair and
    doubles it."""
    ins, out = spec.split("->")
    in_specs = ins.split(",")
    assert len(in_specs) == len(operands)
    info = info or operands[0].info
    sym = all(op.sym for op in operands)
    kind_of = {}
    for op, sub in zip(operands, in_specs):
        assert len(sub) == len(op.kinds), (spec, sub, op.kinds)
        for letter, kind in zip(sub, op.kinds):
            assert kind_of.setdefault(letter, kind) == kind, (spec, letter)
    letters = sorted(kind_of)

    from ecw_cc_tpu.config import get_config
    from ecw_cc_tpu.ops.gemm import gemm_einsum, gemm_einsum_sum

    mode = get_config().soup_gemm
    flip = "flip" in mode
    kconcat = "kconcat" in mode

    # survivors grouped by output block: in 'kconcat' mode the spin-sector
    # sum into one output block rides ONE dot with concatenated contraction
    # axes (fewer, longer GEMMs)
    groups = {}
    order = []
    for combo in itertools.product((0, 1), repeat=len(letters)):
        sp = dict(zip(letters, combo))
        okey = tuple(sp[c] for c in out)
        if sym and (not _is_canon(okey) if out else not _is_canon(combo)):
            continue   # the mirror assignment produces the mirror block
        subs = []
        ok = True
        for op, sub in zip(operands, in_specs):
            val = op.get(tuple(sp[c] for c in sub))
            if val is None:
                ok = False
                break
            subs.append(val)
        if not ok:
            continue
        if okey not in groups:
            groups[okey] = []
            order.append(okey)
        groups[okey].append(subs)

    out_blocks = {}
    for okey in order:
        subs_list = groups[okey]
        if kconcat and len(subs_list) > 1 and len(in_specs) == 2:
            val = gemm_einsum_sum(spec, subs_list, flip=flip)
        else:
            val = gemm_einsum(spec, *subs_list[0], flip=flip) \
                if len(in_specs) == 2 else gemm_einsum(spec, *subs_list[0])
            for subs in subs_list[1:]:
                nxt = gemm_einsum(spec, *subs, flip=flip) \
                    if len(in_specs) == 2 else gemm_einsum(spec, *subs)
                val = val + nxt
        if sym and not out:
            val = val + val   # the skipped mirror assignment's equal share
        out_blocks[okey] = val
    out_kinds = "".join(kind_of[c] for c in out)
    return SpinBlocked(out_kinds, out_blocks, info, sym=sym)


def _pack_keys(kinds, sym):
    """Canonical balanced keys in deterministic order (the pack layout)."""
    keys = [k for k in itertools.product((0, 1), repeat=len(kinds))
            if _balanced(k) and (not sym or _is_canon(k))]
    return sorted(keys)


def pack_balanced(arr, kinds, info, sym=False):
    """Flatten the balanced (canonical when sym) blocks of a sorted-layout
    tensor into one 1-D vector — 37.5% (balanced) / 18.75% (sym) of the
    dense element count for 4-index tensors.  Contiguous slices + concat,
    no gathers.  Exact for tensors whose support really is balanced
    (the solver's structure gates); everything outside is dropped."""
    sl = _slices(info)
    pieces = []
    for key in _pack_keys(kinds, sym):
        idx = tuple(sl[(k, s)] for k, s in zip(kinds, key))
        pieces.append(arr[idx].reshape(-1))
    return jnp.concatenate(pieces)


def unpack_balanced(flat, kinds, info, sym=False):
    """Inverse of pack_balanced: dense sorted-layout tensor with zeros in
    the structurally-zero blocks (and mirrored canonical blocks when sym)."""
    dim_of = {"o": info.nocc, "v": info.nvir}
    size_of = {("o", 0): info.oa, ("o", 1): info.ob,
               ("v", 0): info.va, ("v", 1): info.vb}
    blocks = {}
    off = 0
    for key in _pack_keys(kinds, sym):
        shape = tuple(size_of[(k, s)] for k, s in zip(kinds, key))
        n = 1
        for s in shape:
            n *= s
        blocks[key] = jax.lax.dynamic_slice_in_dim(flat, off, n).reshape(shape)
        off += n
    sb = SpinBlocked(kinds, blocks, info, sym=sym)
    return sb.dense(dtype=flat.dtype)


def packed_size(kinds, info, sym=False):
    """Element count of pack_balanced's output (static)."""
    size_of = {("o", 0): info.oa, ("o", 1): info.ob,
               ("v", 0): info.va, ("v", 1): info.vb}
    total = 0
    for key in _pack_keys(kinds, sym):
        n = 1
        for k, s in zip(kinds, key):
            n *= size_of[(k, s)]
        total += n
    return total


def div_eijab(sb, diag_oo, diag_vv):
    """Per-block division of an 'oovv' SpinBlocked tensor by the orbital
    denominator e_ijab (reference CCSD.py:283-285,332-337 division step).
    Bitwise-identical to the dense `x / (eia[:,None,:,None] +
    eia[None,:,None,:])` on the stored blocks (same add/sub order), but
    touches only the balanced (canonical when sym) blocks — the r5 byte
    cut for the sector-blocked update tails (ops/ccsd_sect.py)."""
    assert sb.kinds == "oovv", sb.kinds
    sl = _slices(sb.info)
    blocks = {}
    for key, val in sb.blocks.items():
        ei_a = (diag_oo[sl[("o", key[0])]][:, None]
                - diag_vv[sl[("v", key[2])]][None, :])
        ej_b = (diag_oo[sl[("o", key[1])]][:, None]
                - diag_vv[sl[("v", key[3])]][None, :])
        blocks[key] = val / (ei_a[:, None, :, None] + ej_b[None, :, None, :])
    return SpinBlocked(sb.kinds, blocks, sb.info, sym=sb.sym)


def spin_flip_asymmetry(arr, kinds, info):
    """max|block[key] - block[flip(key)]| over the balanced canonical keys
    of a sorted-layout tensor — 0 iff the tensor is exactly closed-shell
    mirror symmetric.  Jittable (device-side; fetch the scalar once)."""
    if info.oa != info.ob or info.va != info.vb:
        return jnp.asarray(jnp.inf, dtype=arr.dtype)
    sl = _slices(info)
    worst = jnp.asarray(0.0, dtype=arr.dtype)
    for key in itertools.product((0, 1), repeat=len(kinds)):
        if not _balanced(key) or not _is_canon(key):
            continue
        idx = tuple(sl[(k, s)] for k, s in zip(kinds, key))
        mid = tuple(sl[(k, 1 - s)] for k, s in zip(kinds, key))
        worst = jnp.maximum(worst, jnp.max(jnp.abs(arr[idx] - arr[mid])))
    return worst


def is_spin_restricted(mat, info, tol=0.0):
    """True if a (dim, dim) sorted-layout matrix is spin-block-diagonal
    AND its alpha-alpha block equals its beta-beta block (the closed-shell
    mirror-symmetry condition for one-electron operators).  Host-side."""
    import numpy as np

    if info.oa != info.ob or info.va != info.vb:
        return False
    if not is_block_diagonal(mat, info, tol=tol):
        return False
    m = np.asarray(mat)
    oa, no, va = info.oa, info.nocc, info.va
    a_idx = np.concatenate([np.arange(0, oa), no + np.arange(0, va)])
    b_idx = np.concatenate([np.arange(oa, no), no + va + np.arange(0, va)])
    diff = m[np.ix_(a_idx, a_idx)] - m[np.ix_(b_idx, b_idx)]
    return float(np.max(np.abs(diff), initial=0.0)) <= tol


def is_block_diagonal(mat, info, tol=0.0):
    """True if a (dim, dim) matrix in the SORTED layout has no alpha-beta
    coupling (the condition under which the solver's amplitudes keep their
    spin structure and the sectored soup is exact).  Host-side check."""
    import numpy as np

    m = np.asarray(mat)
    n = info.nocc + info.nvir
    spin = np.zeros(n, dtype=int)
    spin[info.oa:info.nocc] = 1
    spin[info.nocc + info.va:] = 1
    off = m[spin[:, None] != spin[None, :]]
    return float(np.max(np.abs(off), initial=0.0)) <= tol
