"""L1-regularization machinery (vectorized; reference utilities.py:26-96).

The reference implements the Ivanov et al. (Mol. Phys. 115, 2017) sub-gradient
with explicit index loops; here both `subdiff` and `prox_l1` are elementwise
`where` chains, jit/vmap-safe.

Behavioral note (replicated exactly): the reference's zero-branch test is
`v <= 0` while the nonzero branch is `|v| > 0`, so strictly negative
amplitudes fall through to the soft-threshold rule rather than `eq - alpha`
(utilities.py:53-67).  At alpha=0 both rules reduce to `eq`, which is the
invariant the reference tests (CCS.py:2727-2742).
"""

from __future__ import annotations

import jax.numpy as jnp


def subdiff(eq, var, alpha):
    """Sub-gradient W of the L1-regularized residual. Reference utilities.py:26-73."""
    soft = jnp.where(eq < -alpha, eq + alpha, jnp.where(eq > alpha, eq - alpha, 0.0))
    return jnp.where(var > 0.0, eq + alpha * jnp.sign(var), soft)


def prox_l1(x, alpha):
    """Proximal soft-threshold map. Reference utilities.py:76-96."""
    return jnp.where(x > alpha, x - alpha, jnp.where(x < -alpha, x + alpha, 0.0))
