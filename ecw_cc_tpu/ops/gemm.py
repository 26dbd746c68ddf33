"""Flat-GEMM einsum: collapse 2-operand contractions to one 2-D dot.

A dot_general with MULTIPLE contracting/free dimensions can lower to a
slower kernel than the identical data as one flat (M,K)x(K,N) GEMM (this
engine was written for an accelerator where the gap was large at CC kernel
shapes, e.g. `ijcd,klcd->ijkl`; its size on the GPU is not measured).  The
fix must not ADD memory traffic, though: transposing arbitrary operands
into GEMM layout costs materialized copies.  `gemm_einsum` therefore
flattens ONLY when both operands carry their contraction letters as a
contiguous PREFIX or SUFFIX in matching order — then the reshape is free
and the single-contracting-dim lax.dot_general replaces the multi-dim form
at zero byte cost (the hot families this covers: the o^4 v^2
woooo/X/ltau terms and the tau.ovvv Y twins).

Everything else falls back to jnp.einsum unchanged (same transposes it
would have emitted anyway).  Exact: same multiply-add set, flattened
reduction order (f64 parity ~1e-15 rel).  Differentiable and vmap-safe
(reshape/dot_general only).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax


def _plan(spec):
    """Static plan for a 2-operand spec, or None to fall back.

    Plan = (nfa, nfb, a_pre, b_pre, perm_o): whether each operand carries
    the contraction block as prefix (True) or suffix (False), and the
    output transpose (einsum would emit the same one)."""
    if "->" not in spec or "." in spec:
        return None
    ins, out = spec.split("->")
    parts = ins.split(",")
    if len(parts) != 2:
        return None
    la, lb = parts
    if len(set(la)) != len(la) or len(set(lb)) != len(lb) \
            or len(set(out)) != len(out):
        return None
    sa, sb, so = set(la), set(lb), set(out)
    if not so <= (sa | sb):
        return None
    if sa & sb & so:                   # batch letters
        return None
    if (sa - sb - so) or (sb - sa - so):   # implicit single-operand sums
        return None
    ca = [c for c in la if c in sb and c not in so]
    if not ca:
        return None                    # outer product: einsum is fine
    k = len(ca)

    def block(letters):
        if list(letters[:k]) == ca:
            return True                # prefix
        if list(letters[-k:]) == ca:
            return False               # suffix
        return None

    a_pre = block(la)
    b_pre = block(lb)
    if a_pre is None or b_pre is None:
        return None                    # needs an operand transpose: bail
    fa = [c for c in la if c not in ca]
    fb = [c for c in lb if c not in ca]
    perm_o = tuple((fa + fb).index(c) for c in out)
    return len(fa), len(fb), a_pre, b_pre, perm_o


_PLANS = {}


def gemm_einsum(spec, *ops, **kw):
    """Drop-in jnp.einsum replacement routing eligible 2-operand
    contractions through one flat single-contracting-dim dot (see module
    docstring).

    flip=True emits the TRANSPOSED orientation — dot(B2, A2) with output
    (N, M) — so the larger free dimension streams through the GEMM as the
    matmul M; the extra output transpose is on the (small) result, never
    an operand (small-M sector GEMMs pay the systolic
    pipeline latency per tile pass)."""
    flip = kw.pop("flip", False)
    kw.pop("optimize", None)   # meaningless for the 2-operand flat route
    if len(ops) != 2 or kw:
        if len(ops) > 2:
            kw.setdefault("optimize", True)
        return jnp.einsum(spec, *ops, **kw)
    spec = spec.replace(" ", "")
    plan = _PLANS.get(spec, False)
    if plan is False:
        plan = _PLANS[spec] = _plan(spec)
    if plan is None:
        return jnp.einsum(spec, *ops)
    nfa, nfb, a_pre, b_pre, perm_o = plan
    a, b = ops
    sa = a.shape[a.ndim - nfa:] if a_pre else a.shape[:nfa]
    sb = b.shape[b.ndim - nfb:] if b_pre else b.shape[:nfb]
    M = int(np.prod(sa, dtype=np.int64)) if sa else 1
    N = int(np.prod(sb, dtype=np.int64)) if sb else 1
    A2 = a.reshape((-1, M) if a_pre else (M, -1))
    B2 = b.reshape((-1, N) if b_pre else (N, -1))
    if flip and N > M:
        dn = (((0 if b_pre else 1,), (0 if a_pre else 1,)), ((), ()))
        O = lax.dot_general(B2, A2, dn)            # (N, M)
        O = O.reshape(tuple(sb) + tuple(sa))
        # perm_o indexes the (fa + fb) axis order; axis i of (fa+fb) sits
        # at position map_[i] of the flipped (fb + fa) layout
        map_ = [len(sb) + i for i in range(len(sa))] + list(range(len(sb)))
        perm = tuple(map_[p] for p in perm_o)
        if perm != tuple(range(O.ndim)):
            O = jnp.transpose(O, perm)
        return O
    dn = (((0 if a_pre else 1,), (0 if b_pre else 1,)), ((), ()))
    O = lax.dot_general(A2, B2, dn)
    O = O.reshape(tuple(sa) + tuple(sb))
    if perm_o != tuple(range(O.ndim)):
        O = jnp.transpose(O, perm_o)
    return O


def gemm_einsum_sum(spec, subs_list, flip=False):
    """sum_k einsum(spec, *subs_list[k]) as ONE flat dot: the k
    contributions' contraction axes are CONCATENATED (each pair may have a
    different contraction size; the free shapes must match).  Used by
    spinsect.sector_einsum in 'kconcat' mode — the spin-sector sum into one
    output block rides one GEMM instead of k.  The
    concat copies are operand-block-sized (KB-scale at CC shapes).  Exact:
    the same multiply-add set, one flat reduction."""
    subs_list = list(subs_list)
    if len(subs_list) == 1:
        return gemm_einsum(spec, *subs_list[0], flip=flip)
    spec = spec.replace(" ", "")
    plan = _PLANS.get(spec, False)
    if plan is False:
        plan = _PLANS[spec] = _plan(spec)
    if plan is None or any(len(subs) != 2 for subs in subs_list):
        out = gemm_einsum(spec, *subs_list[0])
        for subs in subs_list[1:]:
            out = out + gemm_einsum(spec, *subs)
        return out
    nfa, nfb, a_pre, b_pre, perm_o = plan
    a0, b0 = subs_list[0]
    sa = a0.shape[a0.ndim - nfa:] if a_pre else a0.shape[:nfa]
    sb = b0.shape[b0.ndim - nfb:] if b_pre else b0.shape[:nfb]
    for a, b in subs_list[1:]:
        sa2 = a.shape[a.ndim - nfa:] if a_pre else a.shape[:nfa]
        sb2 = b.shape[b.ndim - nfb:] if b_pre else b.shape[:nfb]
        if sa2 != sa or sb2 != sb:
            out = gemm_einsum(spec, *subs_list[0])
            for subs in subs_list[1:]:
                out = out + gemm_einsum(spec, *subs)
            return out
    M = int(np.prod(sa, dtype=np.int64)) if sa else 1
    N = int(np.prod(sb, dtype=np.int64)) if sb else 1
    A2 = jnp.concatenate(
        [a.reshape((-1, M) if a_pre else (M, -1)) for a, _ in subs_list],
        axis=0 if a_pre else 1)
    B2 = jnp.concatenate(
        [b.reshape((-1, N) if b_pre else (N, -1)) for _, b in subs_list],
        axis=0 if b_pre else 1)
    if flip and N > M:
        dn = (((0 if b_pre else 1,), (0 if a_pre else 1,)), ((), ()))
        O = lax.dot_general(B2, A2, dn).reshape(tuple(sb) + tuple(sa))
        map_ = [len(sb) + i for i in range(len(sa))] + list(range(len(sb)))
        perm = tuple(map_[p] for p in perm_o)
        if perm != tuple(range(O.ndim)):
            O = jnp.transpose(O, perm)
        return O
    dn = (((0 if a_pre else 1,), (0 if b_pre else 1,)), ((), ()))
    O = lax.dot_general(A2, B2, dn).reshape(tuple(sa) + tuple(sb))
    if perm_o != tuple(range(O.ndim)):
        O = jnp.transpose(O, perm_o)
    return O
