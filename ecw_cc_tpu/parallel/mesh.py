"""Device-mesh helpers.

The reference has no distributed code at all (SURVEY.md section 2: single
process, single host).  The scaling dimension for ECW-CC is the
virtual-orbital index of the big ERI blocks (the vvvv ladder) and the
embarrassingly-parallel lambda/state axes:

  mesh axes:
    'tp' — tensor parallel: shards vvvv/ovvv/t2/l2 along a virtual axis; the
           ladder contraction becomes a psum over partial contractions that
           XLA inserts automatically from the shardings.
    'dp' — batch parallel: independent lambda values / L1-alpha scans /
           excited states.

XLA inserts the collectives from the shardings; the mesh is a plain device
list (tested on a virtual CPU mesh).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_tp=None, n_dp=1, devices=None):
    """Build a ('dp', 'tp') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_tp is None:
        n_tp = n // n_dp
    if n_tp * n_dp != n:
        raise ValueError(f"mesh {n_dp}x{n_tp} does not match {n} devices")
    dev_array = np.asarray(devices).reshape(n_dp, n_tp)
    return Mesh(dev_array, axis_names=("dp", "tp"))


def replicated(mesh):
    return NamedSharding(mesh, P())
