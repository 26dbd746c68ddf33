"""Ground-state ECW-CCS / ECW-CCSD solvers.

Re-implements reference Solver_GS.py (Solver_CCS.SCF :101-239,
Solver_CCSD.SCF :621-742) with the same iteration structure, convergence
criteria ('Ep' | 'l' | 'tl'), DIIS modes ('' | 'tl' | 'rdm1'), L1
regularization, divergence guards and warm starting — but device-first:

  - `SCF(...)` runs a host loop over jitted kernel steps with the host Vexp
    engine (supports every target type, including structure factors);
  - `SCF_device(...)` compiles the ENTIRE solve as one lax.while_loop with
    the fused device Vexp (mat/Ek/v1e/dip targets), on-device DIIS ring
    buffer and status-coded exits replacing the reference's mid-loop breaks
    (divergence guard Dconv > 10 / 1.0, maxiter).

Both paths produce the reference's return tuple:
  (conv_text, Ep_it, Delta_it, conv_it, rdm1, final_amplitudes)
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp

import os

from ecw_cc_tpu.config import get_config
from ecw_cc_tpu.ops import ccs as ccs_ops
from ecw_cc_tpu.ops import ccsd as ccsd_ops
from ecw_cc_tpu.ops import ccsd_sect
from ecw_cc_tpu.ops import diis as diis_ops
from ecw_cc_tpu.ops import spinsect
from ecw_cc_tpu.ops import ladder as ladder_ops
from ecw_cc_tpu.ops.vexp import make_gs_vexp_device
from ecw_cc_tpu.models.scf import HostDIIS
from ecw_cc_tpu.utils.metrics import IterationMetrics

_DEVICE_PROPS = ("mat", "Ek", "v1e", "dip", "F")


def _perm2(t, o_idx, v_idx):
    """Apply occ/vir index maps to a (nocc, nvir) amplitude (works for jnp
    and np arrays; used for the spin-sorted <-> alternating layout moves)."""
    return t[o_idx][:, v_idx]


def _perm4(t, o_idx, v_idx):
    """Apply occ/vir index maps to a (nocc, nocc, nvir, nvir) amplitude."""
    return t[o_idx][:, o_idx][:, :, v_idx][:, :, :, v_idx]


def _record_metrics(solver_obj, name, L, Ep_it, Delta_it, conv_it):
    """Populate solver.last_metrics from the per-iteration histories
    (structured replacement for the reference's print-based tables; emits
    JSON lines to $ECW_CC_TPU_METRICS when set)."""
    m = IterationMetrics(solver=name, L=float(L) if np.isscalar(L) else None)
    for i, Ep in enumerate(np.atleast_1d(Ep_it)):
        row = {"Ep": float(Ep)}
        if i < len(conv_it):
            row["conv"] = float(conv_it[i])
        if i < len(Delta_it):
            d = np.ravel(Delta_it[i])
            row["Delta"] = float(d[0])
            if d.size == 2:
                row["vmax"] = float(d[1])
        m.record(i, **row)
    solver_obj.last_metrics = m
    path = os.environ.get("ECW_CC_TPU_METRICS")
    if path:
        m.write(path)
    return m


def _conv_text(status, L, n_ite, alpha=None, ccsd=False):
    if status == 1:
        if ccsd:
            return (f"Convergence reached for lambda= {L} and alpha={alpha}, "
                    f"after {n_ite} iteration")
        return f"Convergence reached for lambda= {L}, after {n_ite} iteration"
    if status == 2:
        return "Max iteration reached"
    return f"Diverges for lambda = {L} after {n_ite} iterations"


class Solver_CCS:
    """Reference API: Solver_GS.Solver_CCS (Solver_GS.py:22-239)."""

    def __init__(self, mycc, VX_exp, conv="tl", conv_thres=1e-6, tsini=None,
                 lsini=None, diis="", maxiter=40, maxdiis=15, CCS_grad=None,
                 mindiis=2):
        self.nocc = mycc.nocc
        self.nvir = mycc.nvir
        self.mycc = mycc
        self.myVexp = VX_exp
        self.Grad = CCS_grad
        # CCS kernels consume the alternating MO layout (no mo_perm
        # support here); a spin-sorted handle scrambles them silently
        from ecw_cc_tpu.models.eris import warn_if_sorted_layout

        warn_if_sorted_layout(mycc.eris, "Solver_CCS")
        self.diis = diis
        self.maxdiis = maxdiis
        self.mindiis = mindiis
        self.maxiter = maxiter
        self.conv_thres = conv_thres
        if conv not in ("Ep", "l", "tl"):
            raise ValueError("Accepted convergence parameter is Ep, l or tl")
        self.conv = conv
        self.fock = mycc.fock
        dt = self.fock.dtype
        self.tsini = (jnp.zeros((self.nocc, self.nvir), dtype=dt) if tsini is None
                      else jnp.asarray(tsini, dtype=dt))
        self.lsini = (jnp.zeros((self.nocc, self.nvir), dtype=dt) if lsini is None
                      else jnp.asarray(lsini, dtype=dt))
        self._device_ok = all(p in _DEVICE_PROPS
                              for p in self.myVexp.prop_names[0])

    # -- convergence variable -------------------------------------------
    def _conv_vec(self, ts, ls, fsp):
        if self.conv == "tl":
            return ts + ls
        if self.conv == "l":
            return ls
        return self.mycc.energy_ccs(ts, fsp).reshape(1)

    def SCF(self, L, ts=None, ls=None, diis="", alpha=None, store_ite=False):
        """Host-orchestrated SCF+DIIS (reference Solver_GS.py:101-239)."""
        if self._device_ok and not store_ite:
            return self.SCF_device(L, ts=ts, ls=ls, diis=diis, alpha=alpha)
        return self._scf_host(L, ts=ts, ls=ls, diis=diis, alpha=alpha,
                              store_ite=store_ite)

    def _scf_host(self, L, ts=None, ls=None, diis="", alpha=None, store_ite=False):
        mycc = self.mycc
        VXexp = self.myVexp
        ts = self.tsini if ts is None else jnp.asarray(ts)
        ls = self.lsini if ls is None else jnp.asarray(ls)
        diis = diis or self.diis
        rdm1 = mycc.gamma(ts, ls)
        nocc, nvir = self.nocc, self.nvir
        dim = nocc + nvir

        cl_diis = HostDIIS(space=self.maxdiis, min_space=self.mindiis) if diis else None
        conv = 0.0
        Dconv = 1.0
        ite = 0
        Delta_ite, Ep_ite, conv_ite = [], [], []
        ts_ite, ls_ite = [], []
        Conv_text = ""
        while Dconv > self.conv_thres:
            conv_old = conv
            Delta, vmax = VXexp.Vexp_update(np.asarray(rdm1), np.asarray(rdm1),
                                            (0, 0), L=L)
            fsp = jnp.asarray(self.fock - VXexp.Vexp[0, 0])
            Delta_ite.append((Delta, vmax))
            T1inter = mycc.T1inter(ts, fsp)
            ts = (mycc.tsupdate(ts, T1inter) if alpha is None
                  else mycc.tsupdate_L1(ts, T1inter, alpha))
            L1inter = mycc.L1inter(ts, fsp)
            ls = (mycc.lsupdate(ts, ls, L1inter) if alpha is None
                  else mycc.lsupdate_L1(ls, L1inter, alpha))
            if diis == "tl":
                vec = np.concatenate([np.ravel(ls), np.ravel(ts)])
                ls, ts = np.split(cl_diis.update(vec), 2)
                ts = jnp.asarray(ts.reshape(nocc, nvir))
                ls = jnp.asarray(ls.reshape(nocc, nvir))
            rdm1 = mycc.gamma(ts, ls)
            if diis == "rdm1":
                rdm1 = jnp.asarray(
                    cl_diis.update(np.ravel(rdm1)).reshape(dim, dim))
            Ep = float(mycc.energy_ccs(ts, fsp))
            Ep_ite.append(Ep)
            conv = np.asarray(self._conv_vec(ts, ls, fsp))
            if ite > 0:
                Dconv = float(np.linalg.norm(conv - conv_old))
            conv_ite.append(Dconv)
            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 10.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
            if store_ite:
                ts_ite.append(np.asarray(ts))
                ls_ite.append(np.asarray(ls))
        else:
            Conv_text = f"Convergence reached for lambda= {L}, after {ite} iteration"

        _record_metrics(self, "CCS", L, Ep_ite, Delta_ite, conv_ite)
        if store_ite:
            return (Conv_text, np.asarray(Ep_ite), np.asarray(Delta_ite),
                    np.asarray(conv_ite), np.asarray(rdm1),
                    np.asarray(ts_ite), np.asarray(ls_ite))
        return (Conv_text, np.asarray(Ep_ite), np.asarray(Delta_ite),
                np.asarray(conv_ite), np.asarray(rdm1),
                (np.asarray(ts), np.asarray(ls)))

    # ------------------------------------------------------------------
    # fully-jitted path
    # ------------------------------------------------------------------
    def _build_device_solver(self, diis, alpha):
        vexp_fn = make_gs_vexp_device(self.myVexp)
        nocc, nvir = self.nocc, self.nvir
        dim = nocc + nvir
        maxiter = self.maxiter
        thres = self.conv_thres
        conv_kind = self.conv
        mindiis = self.mindiis
        use_l1 = alpha is not None
        hist_len = maxiter + 2

        # eris is a jit ARGUMENT, not a closure constant (closure-captured
        # device arrays become constants baked into the program)
        @jax.jit
        def run(eris, L, ts0, ls0, alpha_v):
            def conv_vec(ts, ls, fsp):
                if conv_kind == "tl":
                    return (ts + ls).ravel()
                if conv_kind == "l":
                    return ls.ravel()
                return ccs_ops.energy_ccs(eris, ts, fsp).reshape(1)

            def body(carry):
                (ts, ls, rdm1, dstate, conv, Dconv, ite, k, status,
                 Ep_h, Delta_h, vmax_h, conv_h, Lw, alpha_v) = carry
                conv_old = conv
                V, Delta, vmax = vexp_fn(rdm1, Lw)
                fsp = eris.fock - V
                T1i = ccs_ops.T1inter(eris, ts, fsp)
                if use_l1:
                    ts = ccs_ops.tsupdate_L1(eris, ts, T1i, alpha_v)
                else:
                    ts = ccs_ops.tsupdate(eris, ts, T1i)
                L1i = ccs_ops.L1inter(eris, ts, fsp)
                if use_l1:
                    ls = ccs_ops.lsupdate_L1(eris, ls, L1i, alpha_v)
                else:
                    ls = ccs_ops.lsupdate(eris, ts, ls, L1i)
                if diis == "tl":
                    dstate, vec = diis_ops.diis_update(
                        dstate, jnp.concatenate([ls.ravel(), ts.ravel()]),
                        mindiis)
                    ls = vec[: nocc * nvir].reshape(nocc, nvir)
                    ts = vec[nocc * nvir:].reshape(nocc, nvir)
                rdm1 = ccs_ops.gamma_CCS(ts, ls)
                if diis == "rdm1":
                    dstate, vec = diis_ops.diis_update(dstate, rdm1.ravel(),
                                                       mindiis)
                    rdm1 = vec.reshape(dim, dim)
                Ep = ccs_ops.energy_ccs(eris, ts, fsp)
                conv = conv_vec(ts, ls, fsp)
                Dconv = jnp.where(ite > 0, jnp.linalg.norm(conv - conv_old),
                                  Dconv)
                Ep_h = Ep_h.at[k].set(Ep)
                Delta_h = Delta_h.at[k].set(Delta)
                vmax_h = vmax_h.at[k].set(vmax)
                conv_h = conv_h.at[k].set(Dconv)
                status = jnp.where(ite >= maxiter, 2,
                                   jnp.where(Dconv > 10.0, 3, status))
                ite = jnp.where(status == 0, ite + 1, ite)
                return (ts, ls, rdm1, dstate, conv, Dconv, ite, k + 1, status,
                        Ep_h, Delta_h, vmax_h, conv_h, Lw, alpha_v)

            def cond(carry):
                Dconv, status = carry[5], carry[8]
                return (Dconv > thres) & (status == 0)

            rdm1 = ccs_ops.gamma_CCS(ts0, ls0)
            nvec = 2 * nocc * nvir if diis == "tl" else dim * dim
            dstate = diis_ops.diis_init(nvec, self.maxdiis, dtype=ts0.dtype)
            conv0 = jnp.zeros_like(conv_vec(ts0, ls0, eris.fock))
            carry = (ts0, ls0, rdm1, dstate, conv0,
                     jnp.asarray(1.0, ts0.dtype), jnp.asarray(0, jnp.int32),
                     jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                     jnp.zeros(hist_len, ts0.dtype), jnp.zeros(hist_len, ts0.dtype),
                     jnp.zeros(hist_len, ts0.dtype), jnp.zeros(hist_len, ts0.dtype),
                     L, alpha_v)
            out = jax.lax.while_loop(cond, body, carry)
            (ts, ls, rdm1, _, _, Dconv, ite, k, status,
             Ep_h, Delta_h, vmax_h, conv_h, _, _) = out
            status = jnp.where(status == 0, 1, status)
            return ts, ls, rdm1, ite, k, status, Ep_h, Delta_h, vmax_h, conv_h

        return run

    def SCF_device(self, L, ts=None, ls=None, diis="", alpha=None):
        dt = self.fock.dtype
        ts = self.tsini if ts is None else jnp.asarray(ts, dtype=dt)
        ls = self.lsini if ls is None else jnp.asarray(ls, dtype=dt)
        diis = diis or self.diis
        # (no precision fields here: the CCS builder stamps none — CCS
        # iterations are o*v-sized and run at the session default)
        key = (diis, alpha is not None)
        if not hasattr(self, "_device_solvers"):
            self._device_solvers = {}
        if key not in self._device_solvers:
            self._device_solvers[key] = self._build_device_solver(diis, alpha)
        run = self._device_solvers[key]
        Lw = jnp.asarray(self.myVexp.L_check(L)[0], dtype=ts.dtype)
        alpha_v = jnp.asarray(0.0 if alpha is None else alpha, dtype=ts.dtype)
        out = run(self.mycc.eris, Lw, ts, ls, alpha_v)
        # ONE batched transfer: each np.asarray is a separate round trip
        ts_f, ls_f, rdm1, ite, k, status, Ep_h, Delta_h, vmax_h, conv_h = \
            jax.device_get(out)
        n = int(k)
        text = _conv_text(int(status), L, int(ite))
        Delta_it = np.stack([Delta_h[:n], vmax_h[:n]], axis=1)
        # keep host Vexp state consistent for downstream property queries
        self.myVexp.Vexp_update(rdm1, rdm1, (0, 0), L=L)
        _record_metrics(self, "CCS_device", L, Ep_h[:n], Delta_it, conv_h[:n])
        return (text, Ep_h[:n], Delta_it, conv_h[:n], rdm1, (ts_f, ls_f))

    # -- gradient-based variants (reference Solver_GS.py:245-514) --------
    def Gradient(self, L, method="newton", ts=None, ls=None, diis="", beta=0.1,
                 store_ite=False):
        """Newton / steepest-descent solve via the CCS Jacobian
        (reference Solver_GS.Gradient, with the Vexp_update API fixed —
        the reference calls an obsolete 3-return signature)."""
        if self.Grad is None:
            raise ValueError("a ccs_gradient object is required for Gradient")
        mycc = self.mycc
        VXexp = self.myVexp
        ts = self.tsini if ts is None else jnp.asarray(ts)
        ls = self.lsini if ls is None else jnp.asarray(ls)
        rdm1 = mycc.gamma(ts, ls)
        conv = 0.0
        Dconv = 1.0
        ite = 0
        X2_ite, Ep_ite, conv_ite = [], [], []
        Conv_text = ""
        while Dconv > self.conv_thres:
            conv_old = conv
            X2, vmax = VXexp.Vexp_update(np.asarray(rdm1), np.asarray(rdm1),
                                         (0, 0), L=L)
            fsp = jnp.asarray(self.fock - VXexp.Vexp[0, 0])
            X2_ite.append((X2, vmax))
            if method == "newton":
                ts, ls = self.Grad.Newton(ts, ls, fsp, L)
            elif method == "descend":
                ts, ls = self.Grad.Gradient_Descent(beta, ts, ls, fsp, L)
            else:
                raise ValueError("method must be 'newton' or 'descend'")
            rdm1 = mycc.gamma(ts, ls)
            Ep = float(mycc.energy_ccs(ts, fsp))
            Ep_ite.append(Ep)
            conv = np.asarray(self._conv_vec(ts, ls, fsp))
            if ite > 0:
                Dconv = float(np.linalg.norm(conv - conv_old))
            conv_ite.append(Dconv)
            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 10.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            Conv_text = f"Convergence reached for lambda= {L}, after {ite} iteration"
        return (Conv_text, np.asarray(Ep_ite), np.asarray(X2_ite),
                np.asarray(conv_ite), np.asarray(rdm1),
                (np.asarray(ts), np.asarray(ls)))

    def L1_grad(self, L, alpha, chi, ts=None, ls=None, diis=""):
        """Ivanov-style L1 proximal-gradient solve (reference
        Solver_GS.L1_grad :375-514, with its stale API calls fixed:
        gamma_CCSD -> gamma, Vexp_update signature updated)."""
        mycc = self.mycc
        VXexp = self.myVexp
        ts = np.asarray(self.tsini if ts is None else ts).copy()
        ls = np.asarray(self.lsini if ls is None else ls).copy()
        rdm1 = mycc.gamma(jnp.asarray(ts), jnp.asarray(ls))
        nocc, nvir = self.nocc, self.nvir
        faa = np.diag(np.asarray(self.fock))[nocc:]
        fii = np.diag(np.asarray(self.fock))[:nocc]
        conv = 0.0
        Dconv = 1.0
        ite = 0
        X2_ite, Ep_ite, conv_ite = [], [], []
        Conv_text = ""
        while Dconv > self.conv_thres:
            conv_old = conv
            X2, vmax = VXexp.Vexp_update(np.asarray(rdm1), np.asarray(rdm1),
                                         (0, 0), L=L)
            fsp = jnp.asarray(self.fock - VXexp.Vexp[0, 0])
            X2_ite.append((X2, vmax))
            Teq = np.asarray(mycc.T1eq(jnp.asarray(ts), fsp))
            Leq = np.asarray(mycc.L1eq(jnp.asarray(ts), jnp.asarray(ls), fsp))
            from ecw_cc_tpu.ops.l1reg import subdiff
            dWT = np.asarray(subdiff(jnp.asarray(Teq), jnp.asarray(ts), alpha))
            dWL = np.asarray(subdiff(jnp.asarray(Leq), jnp.asarray(ls), alpha))
            # proximal step with hard P_0 projection (reference :452-469)
            eia = -fii[:, None] + faa[None, :]
            Xj_t = ts - chi * dWT / eia
            ts = np.where(Xj_t * ts > self.conv_thres, Xj_t, 0.0)
            Xj_l = ls - chi * dWL / eia
            ls = np.where(Xj_l * ls > self.conv_thres, Xj_l, 0.0)
            rdm1 = mycc.gamma(jnp.asarray(ts), jnp.asarray(ls))
            Ep = float(mycc.energy_ccs(jnp.asarray(ts), fsp))
            Ep_ite.append(Ep)
            convv = np.asarray(self._conv_vec(jnp.asarray(ts), jnp.asarray(ls), fsp))
            conv = np.linalg.norm(convv)
            conv_ite.append(conv)
            if ite > 0:
                Dconv = abs(conv - conv_old)
            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 2.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            Conv_text = f"Convergence reached for lambda= {L}, after {ite} iteration"
        return (Conv_text, np.asarray(Ep_ite), np.asarray(X2_ite),
                np.asarray(conv_ite), np.asarray(rdm1),
                (np.asarray(ts), np.asarray(ls)))


class Solver_CCSD:
    """Reference API: Solver_GS.Solver_CCSD (Solver_GS.py:521-742)."""

    def __init__(self, mycc, VX_exp, conv="tl", conv_thres=1e-6, tsini=None,
                 lsini=None, tdini=None, ldini=None, diis="", maxiter=40,
                 maxdiis=15, mindiis=2, energy_term="ref", eris_host=None,
                 vvvv_op=None, mo_perm=None):
        # vvvv_op: prebuilt ladder operand (e.g. the PackedVVVV from
        # build_eris_device(pack_ladder=True), where eris.vvvv is a
        # placeholder); default None derives it from eris.vvvv on first use.
        #
        # mo_perm: the MO permutation (new_from_old) that was applied to the
        # eris layout (build_eris_device(sort_spin=True) ->
        # ops/ladder.spin_sort_perm).  ALL public amplitude/rdm1 inputs and
        # outputs of this solver stay in the reference (alternating)
        # convention: the jitted run sorts amplitudes on entry and unsorts
        # every output (a few cheap device gathers per SOLVE, not per
        # iteration), and the device Vexp targets are permuted once at
        # setup.  Internally the iteration runs entirely in the sorted
        # layout, which is what the SectoredVVVV ladder route requires.
        if vvvv_op is not None:
            self._vvsect = vvvv_op
            self._vvsect_mode = "explicit"  # never invalidated by mode changes
        self.mo_perm = None if mo_perm is None else np.asarray(mo_perm)
        if self.mo_perm is None:
            # without mo_perm the kernels consume the alternating layout;
            # a sorted handle (the f32 production ecw.eris) scrambles them
            from ecw_cc_tpu.models.eris import warn_if_sorted_layout

            warn_if_sorted_layout(mycc.eris, "Solver_CCSD(mo_perm=None)")
        self.nocc = mycc.nocc
        self.nvir = mycc.nvir
        self.fock = mycc.fock
        self.mycc = mycc
        self.myVexp = VX_exp
        self.eris_host = eris_host  # enables refine=True (f64 polish)
        self.diis = diis
        self.maxdiis = maxdiis
        self.mindiis = mindiis
        self.maxiter = maxiter
        self.conv_thres = conv_thres
        self.energy_term = energy_term
        if conv not in ("Ep", "l", "tl"):
            raise ValueError("Accepted convergence parameter is Ep, l or tl")
        self.conv = conv
        nocc, nvir = self.nocc, self.nvir
        if self.mo_perm is not None:
            self._po = self.mo_perm[:nocc]
            self._pv = self.mo_perm[nocc:] - nocc
            self._io = np.argsort(self._po)
            self._iv = np.argsort(self._pv)
            self._ip = np.argsort(self.mo_perm)
            # sector sizes of the sorted layout, assuming the standard
            # alternating [0,1,0,1,...] GHF orbspin the perm was built from
            # (reference Eris.py:57): alpha = even original indices
            from ecw_cc_tpu.ops.spinsect import SectorInfo
            gv = nocc + self._pv          # global original vir indices
            self._sinfo = SectorInfo(
                int(np.sum(self._po % 2 == 0)), int(np.sum(self._po % 2 == 1)),
                int(np.sum(gv % 2 == 0)), int(np.sum(gv % 2 == 1)))
        else:
            self._sinfo = None
        dt = self.fock.dtype
        self.tsini = (jnp.zeros((nocc, nvir), dtype=dt) if tsini is None
                      else jnp.asarray(tsini, dtype=dt))
        self.lsini = (jnp.zeros((nocc, nvir), dtype=dt) if lsini is None
                      else jnp.asarray(lsini, dtype=dt))
        if tdini is None:
            mo_e = jnp.diag(self.fock)
            eia = mo_e[:nocc, None] - mo_e[None, nocc:]
            eijab = eia[:, None, :, None] + eia[None, :, None, :]
            tdini = mycc.eris.oovv / eijab
            ldini = tdini
            if self.mo_perm is not None:
                # eris are sorted; the public MP2 guess is alternating
                tdini = _perm4(tdini, self._io, self._iv)
                ldini = tdini
        self.tdini = jnp.asarray(tdini, dtype=dt)
        self.ldini = jnp.asarray(ldini, dtype=dt)
        self._eris_sym_checked = None  # lazy device check (_spin_restricted)
        self._device_ok = all(p in _DEVICE_PROPS
                              for p in self.myVexp.prop_names[0])

    def _vexp_block_diagonal(self):
        """True if every GS target / potential matrix is spin-block-diagonal
        in the SORTED layout — the condition under which the solver's
        amplitudes keep their spin structure and the sector-blocked soup
        kernels (ops/ccsd_sect.py) are exact.  Host-side, checked once per
        built solver."""
        from ecw_cc_tpu.ops.spinsect import is_block_diagonal

        info = self._sinfo
        return all(
            is_block_diagonal(m, info,
                              tol=1e-10 * max(1.0, float(np.abs(m).max())))
            for m in self._vexp_mats_sorted())

    def _vexp_mats_sorted(self):
        """The GS target + potential matrices, permuted to the sorted
        layout (the inputs both structure gates inspect)."""
        P = self.mo_perm
        exp = self.myVexp
        mats = []
        for i, n in enumerate(exp.prop_names[0]):
            if n == "mat":
                mats.append(np.asarray(exp.exp_data[0][i][1])[np.ix_(P, P)])
        for v in exp.dic_int.values():
            arr = np.real(np.asarray(v))
            if arr.ndim == 2:
                mats.append(arr[np.ix_(P, P)])
            else:
                mats.extend(a[np.ix_(P, P)]
                            for a in arr.reshape(-1, *arr.shape[-2:]))
        return mats

    def _spin_restricted(self):
        """Closed-shell mirror-symmetry gate for the sym kernels
        (ops/spinsect.py): equal alpha/beta sector sizes, every GS target /
        potential matrix spin-restricted (block-diagonal AND alpha==beta),
        and the ERI blocks numerically flip-symmetric (one device-side
        check per built solver; an RHF-derived GHF passes at machine
        epsilon, a broken-symmetry reference fails by O(1))."""
        from ecw_cc_tpu.ops.spinsect import (is_spin_restricted,
                                             spin_flip_asymmetry)

        info = self._sinfo
        if info is None or info.oa != info.ob or info.va != info.vb:
            return False
        if not all(
                is_spin_restricted(
                    m, info, tol=1e-10 * max(1.0, float(np.abs(m).max())))
                for m in self._vexp_mats_sorted()):
            return False
        if self._eris_sym_checked is None:
            eris = self.mycc.eris
            eps = float(jnp.finfo(eris.oovv.dtype).eps)
            worst = 0.0
            d = np.asarray(jnp.diag(eris.fock))
            no, va = info.nocc, info.va
            worst = max(
                float(np.max(np.abs(d[:info.oa] - d[info.oa:no]))),
                float(np.max(np.abs(d[no:no + va] - d[no + va:]))))
            scale = 1.0
            for name in ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv",
                         "ovoo", "vovv"):
                blk = getattr(eris, name)
                worst = max(worst, float(spin_flip_asymmetry(blk, name,
                                                             info)))
                scale = max(scale, float(jnp.max(jnp.abs(blk))))
            vv = getattr(self, "_vvsect", None)
            if vv is not None and isinstance(vv, ladder_ops.SectoredVVVV):
                if vv.wc_aa.shape != vv.wc_bb.shape:
                    self._eris_sym_checked = False
                    return False
                worst = max(worst, float(jnp.max(jnp.abs(
                    vv.wc_aa - vv.wc_bb))))
                scale = max(scale, float(jnp.max(jnp.abs(vv.wc_aa))))
            self._eris_sym_checked = worst <= 1e3 * eps * scale
        return self._eris_sym_checked

    def _conv_vec(self, ts, ls, td, ld, fsp):
        if self.conv == "tl":
            return jnp.concatenate([(jnp.abs(ls) + jnp.abs(ts)).ravel(),
                                    (jnp.abs(ld) + jnp.abs(td)).ravel()])
        if self.conv == "l":
            return jnp.concatenate([ls.ravel(), ld.ravel()])
        return self.mycc.energy(ts, td, fsp).reshape(1)

    def SCF(self, L, ts=None, ls=None, td=None, ld=None, alpha=None, diis="",
            keep_device=False, refine=False):
        if self._device_ok:
            return self.SCF_device(L, ts=ts, ls=ls, td=td, ld=ld, alpha=alpha,
                                   diis=diis, keep_device=keep_device,
                                   refine=refine)
        return self._scf_host(L, ts=ts, ls=ls, td=td, ld=ld, alpha=alpha,
                              diis=diis)

    def _scf_host(self, L, ts=None, ls=None, td=None, ld=None, alpha=None, diis=""):
        """Host loop (reference Solver_GS.py:621-742): rdm1-first ordering,
        joint DIIS over (l1, t1, l2, t2), divergence guard Dconv > 1."""
        mycc = self.mycc
        VXexp = self.myVexp
        ts = self.tsini if ts is None else jnp.asarray(ts)
        ls = self.lsini if ls is None else jnp.asarray(ls)
        td = self.tdini if td is None else jnp.asarray(td)
        ld = self.ldini if ld is None else jnp.asarray(ld)
        if self.mo_perm is not None:
            # sorted eris layout: iterate sorted, host Vexp in the public
            # (alternating) convention (cf. _build_device_solver)
            po, pv, io, iv = self._po, self._pv, self._io, self._iv
            ts, ls = _perm2(ts, po, pv), _perm2(ls, po, pv)
            td, ld = _perm4(td, po, pv), _perm4(ld, po, pv)
        diis = diis or self.diis
        nocc, nvir = self.nocc, self.nvir
        dim = nocc + nvir
        cl_diis = HostDIIS(space=self.maxdiis, min_space=self.mindiis) if diis else None
        conv = 0.0
        Dconv = 1.0
        ite = 0
        Delta_ite, Ep_ite, conv_ite = [], [], []
        rdm1 = None
        Conv_text = ""
        while Dconv > self.conv_thres:
            conv_old = conv
            rdm1 = mycc.gamma(ts, td, ls, ld)
            if diis == "rdm1":
                rdm1 = jnp.asarray(
                    cl_diis.update(np.ravel(rdm1)).reshape(dim, dim))
            if self.mo_perm is not None:
                rdm1 = jnp.asarray(np.asarray(rdm1)[np.ix_(self._ip, self._ip)])
                Delta, vmax = VXexp.Vexp_update(np.asarray(rdm1),
                                                np.asarray(rdm1), (0, 0), L=L)
                V = VXexp.Vexp[0, 0][np.ix_(self.mo_perm, self.mo_perm)]
                fsp = jnp.asarray(np.asarray(self.fock) - V)
            else:
                Delta, vmax = VXexp.Vexp_update(np.asarray(rdm1),
                                                np.asarray(rdm1), (0, 0), L=L)
                fsp = jnp.asarray(self.fock - VXexp.Vexp[0, 0])
            Delta_ite.append((Delta, vmax))
            Ep_ite.append(float(mycc.energy(ts, td, fsp)))
            # thread the solver's ladder operand: with pack-on-build ERIs
            # the dense vvvv is a placeholder and the dense route would die
            vv = getattr(self, "_vvsect", None)
            ts, td = mycc.tupdate(ts, td, fsp=fsp, alpha=alpha, vvvv_op=vv)
            ls, ld = mycc.lupdate(ts, td, ls, ld, fsp=fsp, alpha=alpha,
                                  energy_term=self.energy_term, vvvv_op=vv)
            if diis == "tl":
                vec = np.concatenate([np.ravel(ls), np.ravel(ts),
                                      np.ravel(ld), np.ravel(td)])
                vec = cl_diis.update(vec)
                nov = nocc * nvir
                ls = jnp.asarray(vec[:nov].reshape(nocc, nvir))
                ts = jnp.asarray(vec[nov:2 * nov].reshape(nocc, nvir))
                ldv, tdv = np.split(vec[2 * nov:], 2)
                ld = jnp.asarray(ldv.reshape(nocc, nocc, nvir, nvir))
                td = jnp.asarray(tdv.reshape(nocc, nocc, nvir, nvir))
            conv = np.asarray(self._conv_vec(ts, ls, td, ld, fsp))
            if ite > 0:
                Dconv = float(np.linalg.norm(conv - conv_old))
            conv_ite.append(Dconv)
            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 1.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            Conv_text = (f"Convergence reached for lambda= {L} and "
                         f"alpha={alpha}, after {ite} iteration")
        _record_metrics(self, "CCSD", L, Ep_ite, Delta_ite, conv_ite)
        if self.mo_perm is not None:
            ts, ls = _perm2(ts, io, iv), _perm2(ls, io, iv)
            td, ld = _perm4(td, io, iv), _perm4(ld, io, iv)
        return (Conv_text, np.asarray(Ep_ite), np.asarray(Delta_ite),
                np.asarray(conv_ite), np.asarray(rdm1),
                [np.asarray(ts), np.asarray(ls), np.asarray(td), np.asarray(ld)])

    def _build_device_solver(self, diis, use_l1, batched=False):
        # batched=True (SCF_batch's vmapped lanes) keeps the per-lane freeze
        # selects; the unbatched solve skips them at TRACE time — the loop
        # cond already guarantees active=True inside the body, and the
        # freeze's jnp.where over the DIIS history buffers alone copies
        # ~1.3 GB/iteration at pVTZ.
        vexp_fn = make_gs_vexp_device(self.myVexp, perm=self.mo_perm)
        mo_perm = self.mo_perm
        sinfo = None
        sym = False
        if mo_perm is not None:
            po, pv = jnp.asarray(self._po), jnp.asarray(self._pv)
            io, iv = jnp.asarray(self._io), jnp.asarray(self._iv)
            ip = jnp.asarray(self._ip)
            # sector-blocked soup kernels: exact only while the Vexp stays
            # spin-block-diagonal (checked on the actual targets)
            if get_config().soup_sector and self._vexp_block_diagonal():
                sinfo = self._sinfo
                # mirror-symmetry mode: RHF-derived closed shell with
                # spin-restricted Vexp (numerically gated incl. the eris)
                sym = get_config().soup_sym and self._spin_restricted()
        nocc, nvir = self.nocc, self.nvir
        dim = nocc + nvir
        maxiter = self.maxiter
        thres = self.conv_thres
        conv_kind = self.conv
        mindiis = self.mindiis
        energy_term = self.energy_term
        hist_len = maxiter + 2
        nov = nocc * nvir
        nood = nocc * nocc * nvir * nvir

        # DIIS vectors in the balanced-block packed space when the sector
        # gates hold: amplitudes live entirely in the balanced (canonical
        # when sym) spin blocks, so packing is lossless and the DIIS ring
        # buffers — the largest per-iteration HBM reads at pVTZ (~1.3 GB
        # with space=15) — shrink to 37.5% / 18.75% of dense.
        if sinfo is not None:
            from ecw_cc_tpu.ops import spinsect as _ss
            _p_ov = lambda a: _ss.pack_balanced(a, "ov", sinfo, sym=sym)
            _p_4 = lambda a: _ss.pack_balanced(a, "oovv", sinfo, sym=sym)
            _u_ov = lambda f: _ss.unpack_balanced(f, "ov", sinfo, sym=sym)
            _u_4 = lambda f: _ss.unpack_balanced(f, "oovv", sinfo, sym=sym)
            n_ov = _ss.packed_size("ov", sinfo, sym=sym)
            n_4 = _ss.packed_size("oovv", sinfo, sym=sym)
        else:
            _p_ov = _p_4 = lambda a: a.ravel()
            _u_ov = lambda f: f.reshape(nocc, nvir)
            _u_4 = lambda f: f.reshape(nocc, nocc, nvir, nvir)
            n_ov, n_4 = nov, nood

        iter_prec = get_config().iter_precision

        # eris/vvsect are jit ARGUMENTS (device buffers stay out of the
        # lowered program — a multi-GB closure constant would be baked into
        # it and slow every compile)
        hybrid_switch = get_config().hybrid_switch
        hybrid_fast = get_config().hybrid_fast
        soup_opt = get_config().soup_opt

        @jax.jit
        def run(eris, vvsect, L, ts0, ls0, td0, ld0, alpha_v):
            return _run_impl(eris, vvsect, L, ts0, ls0, td0, ld0, alpha_v)

        def _run_impl(eris, vvsect, L, ts0, ls0, td0, ld0, alpha_v):
            # spin-sorted eris layout: public amplitudes arrive in the
            # reference (alternating) convention — sort them ONCE here
            # (gathers hoisted before the while_loop; outputs are unsorted
            # symmetrically at the bottom).  The iteration itself never
            # pays a permutation.
            if mo_perm is not None:
                ts0, ls0 = _perm2(ts0, po, pv), _perm2(ls0, po, pv)
                td0, ld0 = _perm4(td0, po, pv), _perm4(ld0, po, pv)
            # loop-invariant pre-permuted ERI views (hoisted out of the
            # while_loop by XLA; one-time, vs a 238 MB transpose per
            # iteration in the einsum path).  The sector-blocked kernels
            # slice their own loop-invariant block views instead.
            views0 = (ccsd_ops.make_soup_views(eris)
                      if soup_opt and sinfo is None else None)
            def conv_vec(ts, ls, td, ld, fsp):
                # packed space when the sector gates hold: the skipped
                # components are structural zeros, so every norm of
                # conv - conv_old is unchanged
                if conv_kind == "tl":
                    return jnp.concatenate(
                        [_p_ov(jnp.abs(ls) + jnp.abs(ts)),
                         _p_4(jnp.abs(ld) + jnp.abs(td))])
                if conv_kind == "l":
                    return jnp.concatenate([_p_ov(ls), _p_4(ld)])
                return ccsd_ops.energy(eris, ts, td, fsp).reshape(1)

            def body_impl(carry, upd=None):
                (ts_in, ls_in, td_in, ld_in, dstate_in, conv_in, Dconv, ite,
                 k, status, Ep_h, Delta_h, vmax_h, conv_h, rdm1_out, Lw,
                 alpha_v) = carry
                # under vmap (SCF_batch) the while_loop runs until EVERY lane
                # is done; finished lanes must freeze (mirrors cond).  In the
                # unbatched solve the cond guarantees active=True, so the
                # freeze selects are skipped at trace time (batched=False).
                if batched:
                    active = (Dconv > thres) & (status == 0)
                    frz = lambda a, b: jnp.where(active, a, b)
                else:
                    active = jnp.asarray(True)
                    frz = lambda a, b: a
                ts, ls, td, ld = ts_in, ls_in, td_in, ld_in
                dstate, conv = dstate_in, conv_in
                conv_old = conv
                rdm1 = ccsd_ops.gamma_CCSD(
                    ts, td, ls, ld,
                    inter=(ccsd_sect.gamma_inter_sect(ts, td, ls, ld, sinfo,
                                                      sym=sym)
                           if sinfo is not None else None))
                if diis == "rdm1":
                    dstate, vec = diis_ops.diis_update(dstate, rdm1.ravel(),
                                                       mindiis)
                    rdm1 = vec.reshape(dim, dim)
                V, Delta, vmax = vexp_fn(rdm1, Lw)
                fsp = eris.fock - V
                Ep = ccsd_ops.energy(eris, ts, td, fsp)
                alpha = alpha_v if use_l1 else None
                # upd = (eris', vvsect', cast, views'): run ONLY the
                # t/lambda updates on alternate operands (the 'bf16' mode:
                # bf16-stored blocks + amplitudes halve the HBM traffic of
                # the bandwidth-bound o^3v^3 soup; rdm1/Vexp/energy/DIIS/
                # conv stay f32).  Denominator division stays f32: er_u.fock
                # is kept f32, so eia/eijab promote the result back.
                er_u, vv_u, cast, views_u = ((eris, vvsect, None, views0)
                                             if upd is None else upd)
                fsp_u = fsp if cast is None else fsp.astype(cast)
                ts_u = ts if cast is None else ts.astype(cast)
                td_u = td if cast is None else td.astype(cast)
                ls_u = ls if cast is None else ls.astype(cast)
                ld_u = ld if cast is None else ld.astype(cast)
                # both per-iteration vvvv ladders depend only on PRE-update
                # amplitudes (tau on the t side, l2 on the lambda side):
                # with the packed route they run as ONE stacked GEMM so the
                # (p, p) operand — the largest block in HBM — is read once
                ladder_t = ladder_l = tau_pre = None
                if soup_opt and isinstance(
                        vv_u, (ladder_ops.PackedVVVV, ladder_ops.SectoredVVVV)):
                    if isinstance(vv_u, ladder_ops.PackedVVVV):
                        tau_st = ccsd_ops.make_tau(td_u, ts_u, ts_u)
                        ladder_t, ladder_l = ladder_ops.stacked_packed_contract(
                            vv_u, tau_st, ld_u)
                    elif sinfo is not None:
                        # balanced rows (+ mirror skip when sym): the
                        # structurally-zero occupied row pairs never enter
                        # the sector GEMMs — 4x fewer rows/M-tiles.  tau is
                        # built BLOCKED once (shared with tupdate_sect) and
                        # the ladder results stay blocked to the update
                        # tails — no dense tau / dense ladder assembly.
                        tau_pre = ccsd_sect._tau_b(
                            spinsect.wrap(td_u, "oovv", sinfo, sym=sym),
                            spinsect.wrap(ts_u, "ov", sinfo, sym=sym))
                        ladder_t, ladder_l = \
                            ladder_ops.balanced_stacked_sectored_contract(
                                vv_u, tau_pre, ld_u, sinfo.oa, sym=sym,
                                blocked_info=sinfo)
                    else:
                        tau_st = ccsd_ops.make_tau(td_u, ts_u, ts_u)
                        ladder_t, ladder_l = ladder_ops.stacked_sectored_contract(
                            vv_u, tau_st, ld_u)
                if sinfo is not None:
                    # sector-blocked kernels (sorted layout, structured
                    # Vexp): ~6x fewer soup FLOPs, exact (ops/ccsd_sect.py);
                    # sym additionally skips every mirror spin block
                    ts, td = ccsd_sect.tupdate_sect(
                        er_u, ts_u, td_u, fsp_u, sinfo, alpha=alpha,
                        vvvv_op=vv_u, ladder_pre=ladder_t, sym=sym,
                        tau_pre=tau_pre)
                    tsl = ts if cast is None else ts.astype(cast)
                    tdl = td if cast is None else td.astype(cast)
                    ls, ld = ccsd_sect.lupdate_sect(
                        er_u, tsl, tdl, ls_u, ld_u, fsp_u, sinfo,
                        alpha=alpha, energy_term=energy_term, vvvv_op=vv_u,
                        ladder_pre=ladder_l, sym=sym)
                else:
                    ts, td = ccsd_ops.tupdate(er_u, ts_u, td_u, fsp=fsp_u,
                                              alpha=alpha, vvvv_op=vv_u,
                                              views=views_u,
                                              ladder_pre=ladder_t)
                    # tupdate's f32 denominator division promoted the fresh
                    # ts/td back to f32; re-cast so the lambda update's
                    # t-operands are genuinely bf16-stored too (the HBM
                    # saving this mode exists for)
                    tsl = ts if cast is None else ts.astype(cast)
                    tdl = td if cast is None else td.astype(cast)
                    ls, ld = ccsd_ops.lupdate(er_u, tsl, tdl, ls_u, ld_u,
                                              fsp=fsp_u, alpha=alpha,
                                              energy_term=energy_term,
                                              vvvv_op=vv_u, views=views_u,
                                              ladder_pre=ladder_l)
                dt0 = ts_in.dtype
                ts, td = ts.astype(dt0), td.astype(dt0)
                ls, ld = ls.astype(dt0), ld.astype(dt0)
                vec = None
                if diis == "tl":
                    dstate, vec = diis_ops.diis_update(
                        dstate,
                        jnp.concatenate([_p_ov(ls), _p_ov(ts),
                                         _p_4(ld), _p_4(td)]),
                        mindiis)
                    ls = _u_ov(vec[:n_ov])
                    ts = _u_ov(vec[n_ov:2 * n_ov])
                    ld = _u_4(vec[2 * n_ov:2 * n_ov + n_4])
                    td = _u_4(vec[2 * n_ov + n_4:])
                if vec is not None and conv_kind == "tl":
                    # the packed DIIS vector already holds the exact
                    # canonical components conv_vec would re-pack (packing
                    # is a gather, so |.| and + commute with it): slice it
                    # instead of 4 more oovv-sized packs per iteration
                    conv = jnp.concatenate([
                        jnp.abs(vec[:n_ov]) + jnp.abs(vec[n_ov:2 * n_ov]),
                        jnp.abs(vec[2 * n_ov:2 * n_ov + n_4])
                        + jnp.abs(vec[2 * n_ov + n_4:])])
                else:
                    conv = conv_vec(ts, ls, td, ld, fsp)
                Dconv_new = jnp.where(ite > 0,
                                      jnp.linalg.norm(conv - conv_old), Dconv)
                # freeze finished lanes (trace-time no-op unbatched)
                ts = frz(ts, ts_in)
                ls = frz(ls, ls_in)
                td = frz(td, td_in)
                ld = frz(ld, ld_in)
                dstate = jax.tree.map(frz, dstate, dstate_in)
                conv = frz(conv, conv_in)
                Dconv = frz(Dconv_new, Dconv)
                Ep_h = Ep_h.at[k].set(Ep)
                Delta_h = Delta_h.at[k].set(Delta)
                vmax_h = vmax_h.at[k].set(vmax)
                conv_h = conv_h.at[k].set(Dconv)
                status_new = jnp.where(ite >= maxiter, 2,
                                       jnp.where(Dconv > 1.0, 3, status))
                status = frz(status_new, status)
                ite = jnp.where(active & (status == 0), ite + 1, ite)
                k = jnp.where(active, k + 1, k)
                return (ts, ls, td, ld, dstate, conv, Dconv, ite, k,
                        status, Ep_h, Delta_h, vmax_h, conv_h, rdm1, Lw,
                        alpha_v)

            need_bf16 = (iter_prec == "bf16"
                         or (iter_prec == "hybrid" and hybrid_fast == "bf16"))
            if need_bf16:
                bf = jnp.bfloat16
                # computed once per run call, OUTSIDE the while_loop (loop-
                # invariant); fock stays f32 so denominators divide in f32
                eris_bf = type(eris)(**{
                    f: (getattr(eris, f) if f == "fock"
                        else getattr(eris, f).astype(bf))
                    for f in type(eris)._fields})
                vvsect_bf = (None if vvsect is None else
                             jax.tree.map(lambda a: a.astype(bf), vvsect))
                views_bf = (ccsd_ops.make_soup_views(eris_bf)
                            if soup_opt and sinfo is None else None)
                upd_bf = (eris_bf, vvsect_bf, bf, views_bf)

            def make_body(prec):
                # trace-time context: stamps the chosen matmul precision on
                # every dot inside the iteration ('high'/'default' trade
                # digits for TF32 products, 'bf16' additionally stores
                # blocks and amplitudes in bf16; pair with refine=True — or the
                # 'hybrid' schedule — to recover parity)
                if prec is None:
                    return body_impl
                if prec == "bf16":
                    def body(carry):
                        with jax.default_matmul_precision("default"):
                            return body_impl(carry, upd=upd_bf)
                    return body

                def body(carry):
                    with jax.default_matmul_precision(prec):
                        return body_impl(carry)
                return body

            def cond(carry):
                Dconv, status = carry[6], carry[9]
                return (Dconv > thres) & (status == 0)

            nvec = (2 * n_ov + 2 * n_4) if diis == "tl" else dim * dim
            dstate = diis_ops.diis_init(nvec, self.maxdiis, dtype=ts0.dtype)
            conv0 = jnp.zeros_like(conv_vec(ts0, ls0, td0, ld0, eris.fock))
            carry = (ts0, ls0, td0, ld0, dstate, conv0,
                     jnp.asarray(1.0, ts0.dtype), jnp.asarray(0, jnp.int32),
                     jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                     jnp.zeros(hist_len, ts0.dtype), jnp.zeros(hist_len, ts0.dtype),
                     jnp.zeros(hist_len, ts0.dtype), jnp.zeros(hist_len, ts0.dtype),
                     jnp.zeros((dim, dim), ts0.dtype), L, alpha_v)
            if iter_prec == "hybrid":
                # two-phase schedule: reduced-precision iterations (at
                # hybrid_fast) carry the solve down as far as their roundoff
                # permits, then full-precision f32 iterations finish to
                # conv_thres — the final fixed point satisfies the 'highest'
                # equations, so parity is unaffected by the fast leg.  The
                # fast phase ends at hybrid_switch OR when roundoff stalls
                # the residual (no new best Dconv for 3 iterations — the
                # stall floor depends on system size, so a fixed threshold
                # can't be relied on alone).
                switch = max(thres, hybrid_switch)
                body_fast_inner = make_body(hybrid_fast)

                def fast_active(carry, stall):
                    return ((carry[6] > switch) & (carry[9] == 0)
                            & (stall < jnp.asarray(3, jnp.int32)))

                def body_fast(fc):
                    carry, dmin, stall = fc
                    # under vmap the loop runs until EVERY lane leaves the
                    # fast phase; lanes already past the handoff must freeze
                    # on the FAST predicate (body_impl's own freeze uses the
                    # final thres and would keep them stepping).  Unbatched,
                    # cond_fast guarantees active=True: skip at trace time.
                    new = body_fast_inner(carry)
                    if batched:
                        active = fast_active(carry, stall)
                        carry = jax.tree.map(
                            lambda a, b: jnp.where(active, a, b), new, carry)
                    else:
                        active = jnp.asarray(True)
                        carry = new
                    Dconv = carry[6]
                    # skip the first body call: ite>0 gating leaves Dconv at
                    # its 1.0 placeholder there — it must not seed the
                    # stall detector's best-so-far
                    measured = carry[7] > 1
                    improved = Dconv < 0.95 * dmin
                    stall = jnp.where(active & measured,
                                      jnp.where(improved, 0, stall + 1),
                                      stall)
                    dmin = jnp.where(measured, jnp.minimum(dmin, Dconv),
                                     dmin)
                    return carry, dmin, stall

                def cond_fast(fc):
                    carry, _, stall = fc
                    return fast_active(carry, stall)

                carry, _, _ = jax.lax.while_loop(
                    cond_fast, body_fast,
                    (carry, jnp.asarray(jnp.inf, ts0.dtype),
                     jnp.asarray(0, jnp.int32)))
                # fresh DIIS history for the accurate leg: extrapolating over
                # bf16-noise residual differences poisons the subspace
                # (measured: 34 vs 15 iterations at pVTZ with diis='tl')
                carry = carry[:4] + (jax.tree.map(jnp.zeros_like, carry[4]),
                                     ) + carry[5:]
                # force >= 1 full-precision iteration even when
                # conv_thres >= hybrid_switch (the fast leg may then already
                # satisfy thres, but the docstring promise is that the final
                # fixed point satisfies the 'highest' equations): lift Dconv
                # just above thres so cond() admits the accurate leg, which
                # then re-measures Dconv at full precision
                carry = (carry[:6]
                         + (jnp.maximum(carry[6],
                                        jnp.asarray(thres * 1.5, ts0.dtype)),)
                         + carry[7:])
                out = jax.lax.while_loop(cond, make_body(None), carry)
            else:
                prec = None if iter_prec == "highest" else iter_prec
                out = jax.lax.while_loop(cond, make_body(prec), carry)
            (ts, ls, td, ld, _, _, Dconv, ite, k, status,
             Ep_h, Delta_h, vmax_h, conv_h, rdm1, _, _) = out
            status = jnp.where(status == 0, 1, status)
            if mo_perm is not None:
                # back to the public (alternating) convention
                ts, ls = _perm2(ts, io, iv), _perm2(ls, io, iv)
                td, ld = _perm4(td, io, iv), _perm4(ld, io, iv)
                rdm1 = rdm1[ip][:, ip]
            return ts, ls, td, ld, rdm1, ite, k, status, Ep_h, Delta_h, vmax_h, conv_h

        return run

    def _get_vvvv_op(self):
        """Non-dense ladder operand (PackedVVVV / spin sectors / None) per
        config.ladder_mode; rebuilt when the mode changes between calls
        (mirrors the iter_precision cache-key behavior).  An operand passed
        explicitly at construction (pack-on-build) is never invalidated."""
        mode = get_config().ladder_mode
        cur = getattr(self, "_vvsect_mode", None)
        if cur == "explicit":
            return self._vvsect
        if not hasattr(self, "_vvsect") or cur != mode:
            from ecw_cc_tpu.ops import ladder
            self._vvsect = ladder.make_vvvv_op(self.mycc.eris.vvvv)
            self._vvsect_mode = mode
        return self._vvsect

    def SCF_device(self, L, ts=None, ls=None, td=None, ld=None, alpha=None,
                   diis="", refine=False, refine_iter=6, keep_device=False):
        """Fully-jitted while_loop solve; refine=True follows the f32 device
        solve with `refine_iter` f64 polish iterations on the default device
        (mixed-precision scheme, SURVEY.md section 7 — requires eris_host
        passed at construction), recovering 1e-8 parity from an f32 solve.

        keep_device=True leaves the four amplitude tensors in result[5] as
        DEVICE arrays (histories/rdm1 still come to the host): warm-started
        lambda sweeps keep amplitudes device-resident and skip a host round
        trip of the o^2 v^2 tensors per solve (the ECW driver does)."""
        dt = self.fock.dtype
        ts = self.tsini if ts is None else jnp.asarray(ts, dtype=dt)
        ls = self.lsini if ls is None else jnp.asarray(ls, dtype=dt)
        td = self.tdini if td is None else jnp.asarray(td, dtype=dt)
        ld = self.ldini if ld is None else jnp.asarray(ld, dtype=dt)
        diis = diis or self.diis
        key = (diis, alpha is not None, get_config().iter_precision,
               get_config().hybrid_fast, get_config().hybrid_switch,
               get_config().ladder_mode, get_config().soup_opt,
               get_config().soup_sector, get_config().soup_sym)
        if not hasattr(self, "_device_solvers"):
            self._device_solvers = {}
        if key not in self._device_solvers:
            self._device_solvers[key] = self._build_device_solver(diis, alpha is not None)
        run = self._device_solvers[key]
        Lw = jnp.asarray(self.myVexp.L_check(L)[0], dtype=ts.dtype)
        alpha_v = jnp.asarray(0.0 if alpha is None else alpha, dtype=ts.dtype)
        out = run(self.mycc.eris, self._get_vvvv_op(), Lw,
                  ts, ls, td, ld, alpha_v)
        # ONE batched transfer per solve (each np.asarray is its own
        # round trip)
        if keep_device and not refine:
            ts_f, ls_f, td_f, ld_f = out[:4]
            (rdm1, ite, k, status, Ep_h, Delta_h, vmax_h,
             conv_h) = jax.device_get(out[4:])
        else:
            (ts_f, ls_f, td_f, ld_f, rdm1, ite, k, status,
             Ep_h, Delta_h, vmax_h, conv_h) = jax.device_get(out)
        n = int(k)
        text = _conv_text(int(status), L, int(ite), alpha=alpha, ccsd=True)
        Delta_it = np.stack([Delta_h[:n], vmax_h[:n]], axis=1)
        amps = [ts_f, ls_f, td_f, ld_f]
        if refine:
            if self.eris_host is None:
                raise ValueError("refine=True requires eris_host at "
                                 "Solver_CCSD construction")
            (ts64, ls64, td64, ld64), Ep64, rdm1 = polish_f64(
                self.eris_host, self.myVexp, L,
                (ts_f, ls_f, td_f, ld_f), n_iter=refine_iter, alpha=alpha,
                energy_term=self.energy_term)
            amps = [ts64, ls64, td64, ld64]
            Ep_h = np.concatenate([Ep_h[:n], [Ep64]])
            n += 1
            conv_h = np.concatenate([conv_h[:n - 1], [conv_h[n - 2]]])
            Delta_it = np.concatenate([Delta_it, Delta_it[-1:]], axis=0)
        self.myVexp.Vexp_update(rdm1, rdm1, (0, 0), L=L)
        _record_metrics(self, "CCSD_device", L, Ep_h[:n], Delta_it, conv_h[:n])
        return (text, Ep_h[:n], Delta_it, conv_h[:n], rdm1, amps)

    def SCF_batch(self, Larray, alpha=None, diis=""):
        """Solve ALL lambda values of a sweep simultaneously: the while_loop
        solver vmapped over the lambda batch axis (the 'dp' axis of the
        parallelism plan, SURVEY.md section 5 — independent lambda values are
        embarrassingly parallel; shard the batch over a ('dp','tp') mesh for
        multi-chip sweeps).

        Unlike the sequential sweep this uses COLD starts (no warm-start
        chaining between lambda values, which is inherently sequential), so
        iteration counts per lane differ from the warm-started sweep while
        converged results are identical.

        :return: list of per-lambda result tuples in SCF_device format.
        """
        dt = self.fock.dtype
        diis = diis or self.diis
        key = (diis, alpha is not None, get_config().iter_precision,
               get_config().hybrid_fast, get_config().hybrid_switch,
               get_config().ladder_mode, get_config().soup_opt,
               get_config().soup_sector, get_config().soup_sym,
               "batched")
        if not hasattr(self, "_device_solvers"):
            self._device_solvers = {}
        if key not in self._device_solvers:
            self._device_solvers[key] = self._build_device_solver(
                diis, alpha is not None, batched=True)
        run = self._device_solvers[key]
        nL = len(Larray)
        Lw = jnp.asarray(np.stack([self.myVexp.L_check(float(L))[0]
                                   for L in Larray]), dtype=dt)
        alpha_v = jnp.asarray(0.0 if alpha is None else alpha, dtype=dt)
        tile = lambda a: jnp.broadcast_to(a, (nL,) + a.shape)
        batch = jax.vmap(run, in_axes=(None, None, 0, 0, 0, 0, 0, None))
        out = batch(self.mycc.eris, self._get_vvvv_op(), Lw,
                    tile(self.tsini), tile(self.lsini),
                    tile(self.tdini), tile(self.ldini), alpha_v)
        (ts_f, ls_f, td_f, ld_f, rdm1, ite, k, status,
         Ep_h, Delta_h, vmax_h, conv_h) = jax.device_get(out)
        results = []
        for i, L in enumerate(Larray):
            n = int(k[i])
            text = _conv_text(int(status[i]), float(L), int(ite[i]),
                              alpha=alpha, ccsd=True)
            Delta_it = np.stack([Delta_h[i, :n], vmax_h[i, :n]], axis=1)
            results.append((text, Ep_h[i, :n], Delta_it, conv_h[i, :n],
                            rdm1[i], [ts_f[i], ls_f[i], td_f[i], ld_f[i]]))
        # host Vexp state reflects the last lambda (sequential-sweep parity)
        self.myVexp.Vexp_update(rdm1[-1], rdm1[-1], (0, 0), L=float(Larray[-1]))
        return results


# ---------------------------------------------------------------------------
# Mixed precision: f32 device solve + f64 polish
# ---------------------------------------------------------------------------

def polish_f64(eris_host, VXexp, L, amps, n_iter=6, alpha=None,
               energy_term="ref"):
    """Refine f32-converged ECW-CCSD amplitudes with f64 iterations on the
    default device, recovering 1e-8 parity with a full-f64 solve (the
    mixed-precision scheme from BASELINE.md's hard parts: iterate in f32,
    correct the residual in f64).

    :param eris_host: ErisHost (f64 NumPy blocks)
    :param VXexp: host Vexp engine
    :param L: constraint weight
    :param amps: (ts, ls, td, ld) from the f32 solve
    :param n_iter: number of f64 polish iterations (the f32 fixed point is
        already within ~1e-6; a handful of contraction-steps suffice)
    :return: ((ts, ls, td, ld) in f64, final Ep, final rdm1 in f64) — the
        rdm1 must be built HERE, while x64 is still enabled: computing it
        after this function restores jax_enable_x64=False would silently
        downcast the polished amplitudes to f32 and truncate the density
        back to ~1e-7.
    """
    import jax

    x64_was = jax.config.jax_enable_x64
    if not x64_was:
        # production f32 runs disable x64 globally; the polish needs true f64
        jax.config.update("jax_enable_x64", True)
    try:
        eris64 = eris_host.to_device(dtype="float64")
        ts, ls, td, ld = [jnp.asarray(np.asarray(a, dtype=np.float64))
                          for a in amps]
        fock = np.asarray(eris_host.fock)
        Ep = None
        for _ in range(n_iter):
            rdm1 = ccsd_ops.gamma_CCSD(ts, td, ls, ld)
            VXexp.Vexp_update(np.asarray(rdm1), np.asarray(rdm1), (0, 0), L=L)
            fsp = jnp.asarray(fock - VXexp.Vexp[0, 0])
            Ep = float(ccsd_ops.energy(eris64, ts, td, fsp))
            ts, td = ccsd_ops.tupdate(eris64, ts, td, fsp=fsp, alpha=alpha)
            ls, ld = ccsd_ops.lupdate(eris64, ts, td, ls, ld, fsp=fsp,
                                      alpha=alpha, energy_term=energy_term)
        rdm1 = np.asarray(ccsd_ops.gamma_CCSD(ts, td, ls, ld))
        return (np.asarray(ts), np.asarray(ls), np.asarray(td),
                np.asarray(ld)), Ep, rdm1
    finally:
        if not x64_was:
            jax.config.update("jax_enable_x64", False)
