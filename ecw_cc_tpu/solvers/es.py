"""Excited-state ECW-CCS solver: coupled T, Lambda, R/L/r0/l0 equations.

Re-implements reference Solver_ES.py (class Solver_ES :26-496): per
iteration, all state and transition rdm1s are built, the Vexp[n,m] matrix is
refreshed, the GS t/lambda amplitudes are updated with the ES-coupling terms,
and each excited state's (r, r0, l, l0) is updated with its energy extracted
from the largest amplitude; spin/orthonormality are monitored.  DIIS modes
'GS' | 'ES' | 'all' mirror Solver_ES.py:320-411.

A Davidson-refined variant (`SCF_diag`) replaces the reference's partially
stale SCF_diag (Solver_ES.py:502-862): at each macro-iteration the R1
equations are diagonalized in the full singles space (the intended behavior;
system sizes there are tiny) instead of the power-iteration rsupdate.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp

from ecw_cc_tpu.ops import ccs as ccs_ops
from ecw_cc_tpu.ops import diis as diis_ops
from ecw_cc_tpu.models.scf import HostDIIS
from ecw_cc_tpu.utils import linalg as ulinalg

format_float = "{:.4e}"

try:
    from tabulate import tabulate
except ImportError:  # pragma: no cover
    tabulate = None


import functools


@functools.lru_cache(maxsize=16)
def _diag_matvecs(nocc, nvir):
    """Stable (matvec_r, matvec_l) for SCF_diag's Davidson (the
    pipelined Davidson caches its jitted programs on the matvec
    identity, utils/linalg._pl_programs)."""
    def matvec_r(v, mops):
        Ri, r0c = mops
        return ccs_ops.R1eq(v.reshape(nocc, nvir), r0c, Ri).ravel()

    def matvec_l(v, mops):
        Lii, l0c = mops
        return ccs_ops.es_L1eq(v.reshape(nocc, nvir), l0c, Lii).ravel()

    return matvec_r, matvec_l


class Solver_ES:
    def __init__(self, mycc, Vexp, rn_ini=None, tsini=None, lsini=None,
                 val_core=None, rini_koop_idx=None, conv_var="tl",
                 conv_thres=1e-6, diis="", maxiter=40, maxdiis=20, mindiis=2,
                 tablefmt="rst"):
        self.mycc = mycc
        self.Vexp_class = Vexp
        self.nbr_states = Vexp.nbr_states
        self.tablefmt = tablefmt
        # the ES equations consume the reference (alternating) MO layout;
        # the sorted production handle silently scrambles them (the r4
        # 'f32 ES instability' artifact — models/eris.py docstring)
        from ecw_cc_tpu.models.eris import warn_if_sorted_layout

        warn_if_sorted_layout(mycc.eris, "Solver_ES")
        self.nocc = mycc.nocc
        self.nvir = mycc.nvir
        self.dim = self.nocc + self.nvir
        self.EHF = getattr(mycc.eris, "EHF", None)

        self.tsini = (np.zeros((self.nocc, self.nvir)) if tsini is None
                      else np.asarray(tsini))
        self.lsini = (np.zeros((self.nocc, self.nvir)) if lsini is None
                      else np.asarray(lsini))

        fock_diag = np.diag(np.asarray(mycc.fock))
        if rn_ini is None:
            if val_core is None:
                val_core = [self.nbr_states - 1, 0]
            self.rn_ini, de = ulinalg.koopman_init_guess(
                fock_diag, self._mo_occ(), val_core, koop_idx=rini_koop_idx)
        else:
            if len(rn_ini) != self.nbr_states - 1:
                raise ValueError("number of initial r vectors inconsistent "
                                 "with the experimental data")
            self.rn_ini = [np.asarray(r) for r in rn_ini]
            de = [ulinalg.get_DE(fock_diag, r) for r in self.rn_ini]

        self.ln_ini = [r.copy() for r in self.rn_ini]
        zero_f = np.zeros((self.dim, self.dim))
        self.r0_ini = [float(ccs_ops.r0_fromE(mycc.eris, d, jnp.zeros_like(jnp.asarray(r)),
                                              jnp.asarray(r), jnp.asarray(zero_f)))
                       for r, d in zip(self.rn_ini, de)]
        self.l0_ini = [x for x in self.r0_ini]
        self.E_ini = -np.asarray(de)
        print(" Initial Koopman energies in eV: ", -self.E_ini * 27.2114)

        self.diis = diis
        self.maxdiis = maxdiis
        self.mindiis = mindiis
        self.maxiter = maxiter
        self.conv_thres = conv_thres
        if conv_var not in ("Ep", "rl", "tl", "all"):
            raise ValueError("accepted convergence parameter is Ep, tl, rl or all")
        self.conv_var = conv_var

    def _mo_occ(self):
        occ = np.zeros(self.dim)
        occ[: self.nocc] = 1.0
        return occ

    # -- convergence checks (reference Solver_ES.py:119-140) --------------
    def _conv(self, dic):
        if self.conv_var == "Ep":
            return np.asarray(dic["Ep"]).copy()
        if self.conv_var == "tl":
            return np.asarray(dic["ts"]) + np.asarray(dic["ls"])
        if self.conv_var == "rl":
            ans = np.zeros_like(np.asarray(dic["rn"][0]))
            for r, l in zip(dic["rn"], dic["ln"]):
                ans = ans + np.asarray(r) + np.asarray(l)
            return ans
        ans = np.asarray(dic["ts"]) + np.asarray(dic["ls"])
        for r, l in zip(dic["rn"], dic["ln"]):
            ans = ans + np.asarray(r) + np.asarray(l)
        return ans

    # ------------------------------------------------------------------
    def SCF(self, L=None, dic_amp_ini=None, diis=None, force_alpha=True,
            print_ite=True, use_diag=False):
        """Coupled multi-state SCF (reference Solver_ES.py:146-496)."""
        Vexp_class = self.Vexp_class
        nbr_states = self.nbr_states
        mycc = self.mycc
        eris = mycc.eris
        nocc, nvir = self.nocc, self.nvir

        if L is None:
            L = Vexp_class.L
        else:
            L = Vexp_class.L_check(L)

        if dic_amp_ini is None:
            ts = jnp.asarray(self.tsini)
            ls = jnp.asarray(self.lsini)
            rn = [jnp.asarray(r) for r in self.rn_ini]
            ln = [jnp.asarray(l) for l in self.ln_ini]
            r0n = list(self.r0_ini)
            l0n = list(self.l0_ini)
            # dominant (i,a) of each initial r: argmax of |r| (Koopman unit
            # guesses hit exactly 1; EOM-generated r_ini has no exact-1.0
            # entry, so a `== 1` lookup would be empty — seen as an
            # IndexError with Build_ES_exp_EOM targets)
            ov = []
            for r in self.rn_ini:
                r = np.asarray(r)
                if r.size and np.max(np.abs(r)) > 0:
                    ov.append(tuple(
                        int(x) for x in
                        np.unravel_index(np.argmax(np.abs(r)), r.shape)))
                else:
                    ov.append(None)
        else:
            ts = jnp.asarray(dic_amp_ini["ts"])
            ls = jnp.asarray(dic_amp_ini["ls"])
            rn = [jnp.asarray(r) for r in dic_amp_ini["rn"]]
            ln = [jnp.asarray(l) for l in dic_amp_ini["ln"]]
            r0n = list(dic_amp_ini["r0n"])
            l0n = list(dic_amp_ini["l0n"])
            ov = [None] * (nbr_states - 1)

        dic_amp = {"ts": ts, "ls": ls, "rn": rn, "ln": ln, "r0n": r0n, "l0n": l0n}
        rnew = [None] * (nbr_states - 1)
        lnew = [None] * (nbr_states - 1)
        r0new = [None] * (nbr_states - 1)
        l0new = [None] * (nbr_states - 1)
        fsp = [None] * nbr_states
        rdm1 = [None] * nbr_states
        tr_rdm1 = [None] * (nbr_states - 1)
        Spin = np.zeros(nbr_states - 1)
        diis = self.diis if diis is None else diis

        Delta = np.zeros((nbr_states, nbr_states))
        Ep = np.zeros((nbr_states, 2))
        conv = 0.0
        Dconv = 1.0
        ite = 0
        Delta_ite, Ep_ite, conv_ite = [], [], []
        amp_diis = HostDIIS(space=self.maxdiis, min_space=self.mindiis) if diis else None

        table, headers = [], []
        if print_ite:
            headers = ["ite", "Dconv " + str(self.conv_var)]
            for i in range(nbr_states - 1):
                cols = [f"ES {i + 1}", "norm", "Delta_r", "Delta_l", "2S+1",
                        "r0", "l0", "Er", "El"]
                if i > 0:
                    cols.append("Ortho wrt ES 1")
                headers.extend(cols)

        fock = jnp.asarray(mycc.fock)
        C_norm = np.eye(nbr_states - 1)
        Conv_text = ""

        while Dconv > self.conv_thres:
            conv_old = conv

            # all rdm1 / tr_rdm1 (reference :254-268)
            rdm1[0] = ccs_ops.gamma_CCS(ts, ls)
            for n in range(1, nbr_states):
                rdm1[n] = ccs_ops.gamma_es_CCS(ts, ln[n - 1], rn[n - 1],
                                               r0n[n - 1], l0n[n - 1])
                tr_r = ccs_ops.gamma_tr_CCS(ts, ln[n - 1], jnp.zeros_like(ts),
                                            1.0, l0n[n - 1])
                tr_l = ccs_ops.gamma_tr_CCS(ts, ls, rn[n - 1], r0n[n - 1], 1.0)
                tr_rdm1[n - 1] = [tr_r, tr_l]

            # Vexp updates (reference :274-296).  Vexp[0,0] is reset every
            # macro-iteration: the reference resets it inside the (0,0)
            # Vexp_update, which is skipped when the GS has no target data —
            # the ES DEk contribution would then accumulate unboundedly.
            Vexp_class.Vexp[0, 0] = np.zeros((self.dim, self.dim))
            if Vexp_class.exp_data[0]:
                Delta[0, 0], _ = Vexp_class.Vexp_update(
                    np.asarray(rdm1[0]), tr_rdm1, (0, 0), L=L)
            for n in range(1, nbr_states):
                if Vexp_class.exp_data[n]:
                    names = Vexp_class.prop_names[n]
                    if "trdip" in names or "trmat" in names:
                        Delta[n, 0], _ = Vexp_class.Vexp_update(
                            np.asarray(tr_rdm1[n - 1][0]),
                            np.asarray(tr_rdm1[n - 1][1]), (n, 0), L=L)
                        Delta[0, n], _ = Vexp_class.Vexp_update(
                            np.asarray(tr_rdm1[n - 1][1]),
                            np.asarray(tr_rdm1[n - 1][0]), (0, n), L=L)
                    else:
                        Delta[n, n], _ = Vexp_class.Vexp_update(
                            np.asarray(rdm1[n]), np.asarray(rdm1[0]), (n, n), L=L)
                        fsp[n] = fock - jnp.asarray(Vexp_class.Vexp[n, n])
                if fsp[n] is None:
                    fsp[n] = fock
            if Vexp_class.Vexp[0, 0] is not None:
                fsp[0] = fock - jnp.asarray(np.asarray(Vexp_class.Vexp[0, 0],
                                                       dtype=float))
            else:
                fsp[0] = fock
            Delta_ite.append(Delta.copy())

            # stacked ES quantities for the coupled GS updates
            def stack_v(col):
                # col: list over n of Vexp[0,n] or Vexp[n,0] (may be None)
                out = []
                for v in col:
                    if v is None or np.isscalar(v):
                        out.append(np.zeros((self.dim, self.dim)))
                    else:
                        out.append(np.asarray(v, dtype=float))
                return jnp.asarray(np.stack(out))

            # t update with ES coupling (reference :301-305)
            v0n = stack_v([Vexp_class.Vexp[0, n] for n in range(1, nbr_states)])
            T1i = ccs_ops.T1inter(eris, ts, fsp[0])
            ts = ccs_ops.tsupdate(eris, ts, T1i, rsn=jnp.stack(rn),
                                  r0n=jnp.asarray(r0n), vn=v0n)

            # lambda update with ES coupling (reference :309-314)
            vn0 = stack_v([Vexp_class.Vexp[n, 0] for n in range(1, nbr_states)])
            L1i = ccs_ops.L1inter(eris, ts, fsp[0])
            ls = ccs_ops.lsupdate(eris, ts, ls, L1i, rsn=jnp.stack(rn),
                                  lsn=jnp.stack(ln), r0n=jnp.asarray(r0n),
                                  l0n=jnp.asarray(l0n), vn=vn0)

            if diis == "GS":
                vec = np.concatenate([np.ravel(ls), np.ravel(ts)])
                lsv, tsv = np.split(amp_diis.update(vec), 2)
                ls = jnp.asarray(lsv.reshape(nocc, nvir))
                ts = jnp.asarray(tsv.reshape(nocc, nvir))

            # per-state R/L updates (reference :332-373)
            for n in range(1, nbr_states):
                vexp = Vexp_class.Vexp[0, n]
                vexp = None if (vexp is None or np.isscalar(vexp)) else jnp.asarray(
                    np.asarray(vexp, dtype=float))
                Rinter = ccs_ops.R1inter(eris, ts, fsp[n], vexp)
                En_r, o, v = ccs_ops.Extract_Em_r(eris, rn[n - 1], r0n[n - 1],
                                                  Rinter, ov=ov[n - 1])
                En_r = float(En_r)
                o, v = int(o), int(v)
                rnew[n - 1] = ccs_ops.rsupdate(eris, rn[n - 1], r0n[n - 1],
                                               Rinter, En_r,
                                               force_alpha=force_alpha)
                rov = ccs_ops.get_ov(ln[n - 1], l0n[n - 1], rn[n - 1],
                                     r0n[n - 1], (o, v))
                rnew[n - 1] = rnew[n - 1].at[o, v].set(float(rov))
                r0new[n - 1] = float(ccs_ops.r0_fromE(eris, En_r, ts, rn[n - 1],
                                                      vexp, fsp=fsp[n]))

                vexp_l = Vexp_class.Vexp[n, 0]
                vexp_l = None if (vexp_l is None or np.isscalar(vexp_l)) else \
                    jnp.asarray(np.asarray(vexp_l, dtype=float))
                Linter = ccs_ops.es_L1inter(eris, ts, fsp[n], vexp_l)
                En_l, o, v = ccs_ops.Extract_Em_l(eris, ln[n - 1], l0n[n - 1],
                                                  Linter, ov=ov[n - 1])
                En_l = float(En_l)
                o, v = int(o), int(v)
                lnew[n - 1] = ccs_ops.es_lsupdate(eris, ln[n - 1], l0n[n - 1],
                                                  En_l, Linter,
                                                  force_alpha=force_alpha)
                lov = ccs_ops.get_ov(rn[n - 1], r0n[n - 1], ln[n - 1],
                                     l0n[n - 1], (o, v))
                lnew[n - 1] = lnew[n - 1].at[o, v].set(float(lov))
                l0new[n - 1] = float(ccs_ops.l0_fromE(eris, En_l, ts, ln[n - 1],
                                                      vexp_l, fsp=fsp[n]))
                Ep[n, 0] = En_r
                Ep[n, 1] = En_l

            # DIIS over ES or all amplitudes (reference :376-411)
            if diis == "ES":
                vec = np.concatenate(
                    [np.ravel(rnew[0]), np.ravel(lnew[0]),
                     np.atleast_1d(r0new[0]), np.atleast_1d(l0new[0])])
                vec = amp_diis.update(vec)
                nov = nocc * nvir
                rnew[0] = jnp.asarray(vec[:nov].reshape(nocc, nvir))
                lnew[0] = jnp.asarray(vec[nov:2 * nov].reshape(nocc, nvir))
                r0new[0] = float(vec[-2])
                l0new[0] = float(vec[-1])
            elif diis == "all":
                nES = len(r0new)
                vec = np.concatenate(
                    [np.ravel(ts), np.ravel(ls)]
                    + [np.ravel(r) for r in rnew] + [np.ravel(l) for l in lnew]
                    + [np.atleast_1d(x) for x in r0new]
                    + [np.atleast_1d(x) for x in l0new])
                vec = amp_diis.update(vec)
                nov = nocc * nvir
                ts = jnp.asarray(vec[:nov].reshape(nocc, nvir))
                ls = jnp.asarray(vec[nov:2 * nov].reshape(nocc, nvir))
                for i in range(nES):
                    rnew[i] = jnp.asarray(
                        vec[(2 + i) * nov:(3 + i) * nov].reshape(nocc, nvir))
                    lnew[i] = jnp.asarray(
                        vec[(2 + nES + i) * nov:(3 + nES + i) * nov].reshape(nocc, nvir))
                    r0new[i] = float(vec[-2 * nES + i])
                    l0new[i] = float(vec[-nES + i])

            # orthonormality / spin diagnostics (reference :419-421)
            C_norm = ulinalg.check_ortho([np.asarray(x) for x in lnew],
                                         [np.asarray(x) for x in rnew],
                                         l0new, r0new)
            for i in range(nbr_states - 1):
                Spin[i] = ulinalg.check_spin(np.asarray(rnew[i]), np.asarray(lnew[i]))

            rn = [x for x in rnew]
            ln = [x for x in lnew]
            r0n = list(r0new)
            l0n = list(l0new)
            dic_amp = {"ts": np.asarray(ts), "ls": np.asarray(ls),
                       "rn": [np.asarray(x) for x in rn],
                       "ln": [np.asarray(x) for x in ln],
                       "r0n": r0n, "l0n": l0n}

            # GS energy with ES contributions (reference :436-438)
            vexp0 = stack_v([Vexp_class.Vexp[0, n] for n in range(1, nbr_states)])
            Ep[0, 0] = float(ccs_ops.energy_ccs(eris, ts, fsp[0],
                                                rsn=jnp.stack(rn),
                                                r0n=jnp.asarray(r0n), vn=vexp0))
            Ep_ite.append(Ep.copy())

            conv = self._conv({**dic_amp, "Ep": Ep, "fsp": fsp[0]})
            if ite > 0:
                Dconv = float(np.linalg.norm(conv - conv_old))
            conv_ite.append(Dconv)

            if print_ite:
                tmp = [ite, format_float.format(Dconv)]
                for i in range(nbr_states - 1):
                    cols = ["", format_float.format(C_norm[i, i]),
                            Delta[i + 1, 0], Delta[0, i + 1], 2 * Spin[i] + 1,
                            r0n[i], l0n[i], Ep[i + 1, 0], Ep[i + 1, 1]]
                    if i > 0:
                        cols.append(format_float.format((C_norm[0, i] + C_norm[i, 0]) / 2))
                    tmp.extend(cols)
                table.append(tmp)

            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 10.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            Conv_text = f"Convergence reached for lambda= {L}, after {ite} iteration"

        if print_ite and tabulate is not None:
            print(tabulate(table, headers, tablefmt=self.tablefmt))

        from ecw_cc_tpu.solvers.gs import _record_metrics
        _record_metrics(self, "ES", L if np.isscalar(L) else 0.0,
                        [e[0, 0] for e in Ep_ite], Delta_ite, conv_ite)
        return Conv_text, dic_amp, Delta, Ep, np.asarray(rdm1[0])

    # ------------------------------------------------------------------
    def SCF_diag(self, L=None, dic_amp_ini=None, print_ite=True,
                 davidson=False, max_space=20):
        """Davidson-style variant: at each macro-iteration the R1/L1 updates
        are replaced by diagonalization of the similarity-transformed singles
        matrix (intended behavior of the reference's stale SCF_diag,
        Solver_ES.py:502-862).  With davidson=True the matrix-free
        non-symmetric Davidson solver (utils.linalg.davidson_nosym, the
        analogue of pyscf lib.davidson_nosym1 at Solver_ES.py:710-711) is
        used with the orbital-energy-difference diagonal preconditioner;
        otherwise exact dense diagonalization."""
        Vexp_class = self.Vexp_class
        nbr_states = self.nbr_states
        mycc = self.mycc
        eris = mycc.eris
        nocc, nvir = self.nocc, self.nvir
        if L is None:
            L = Vexp_class.L
        else:
            L = Vexp_class.L_check(L)

        ts = jnp.asarray(self.tsini if dic_amp_ini is None else dic_amp_ini["ts"])
        ls = jnp.asarray(self.lsini if dic_amp_ini is None else dic_amp_ini["ls"])
        rn = [jnp.asarray(r) for r in (self.rn_ini if dic_amp_ini is None
                                       else dic_amp_ini["rn"])]
        ln = [jnp.asarray(l) for l in (self.ln_ini if dic_amp_ini is None
                                       else dic_amp_ini["ln"])]
        r0n = list(self.r0_ini if dic_amp_ini is None else dic_amp_ini["r0n"])
        l0n = list(self.l0_ini if dic_amp_ini is None else dic_amp_ini["l0n"])

        fock = jnp.asarray(mycc.fock)
        Delta = np.zeros((nbr_states, nbr_states))
        Ep = np.zeros((nbr_states, 2))
        conv = 0.0
        Dconv = 1.0
        ite = 0
        Conv_text = ""
        rdm1_gs = None
        nov = nocc * nvir

        while Dconv > self.conv_thres:
            conv_old = conv
            rdm1_gs = ccs_ops.gamma_CCS(ts, ls)
            fsp = [fock] * nbr_states
            if Vexp_class.exp_data[0]:
                Delta[0, 0], _ = Vexp_class.Vexp_update(
                    np.asarray(rdm1_gs), None, (0, 0), L=L)
                fsp[0] = fock - jnp.asarray(np.asarray(Vexp_class.Vexp[0, 0],
                                                       dtype=float))
            for n in range(1, nbr_states):
                rdm1_n = ccs_ops.gamma_es_CCS(ts, ln[n - 1], rn[n - 1],
                                              r0n[n - 1], l0n[n - 1])
                names = Vexp_class.prop_names[n]
                if not Vexp_class.exp_data[n]:
                    continue
                if "trdip" in names or "trmat" in names:
                    # transition Vexp refresh so V^{0n}/V^{n0} can be
                    # threaded into the diagonalized maps (reference
                    # Solver_ES.py:684-744)
                    tr_r = ccs_ops.gamma_tr_CCS(ts, ln[n - 1],
                                                jnp.zeros_like(ts), 1.0,
                                                l0n[n - 1])
                    tr_l = ccs_ops.gamma_tr_CCS(ts, ls, rn[n - 1],
                                                r0n[n - 1], 1.0)
                    Delta[n, 0], _ = Vexp_class.Vexp_update(
                        np.asarray(tr_r), np.asarray(tr_l), (n, 0), L=L)
                    Delta[0, n], _ = Vexp_class.Vexp_update(
                        np.asarray(tr_l), np.asarray(tr_r), (0, n), L=L)
                else:
                    Delta[n, n], _ = Vexp_class.Vexp_update(
                        np.asarray(rdm1_n), np.asarray(rdm1_gs), (n, n), L=L)
                    fsp[n] = fock - jnp.asarray(np.asarray(Vexp_class.Vexp[n, n],
                                                           dtype=float))

            T1i = ccs_ops.T1inter(eris, ts, fsp[0])
            ts = ccs_ops.tsupdate(eris, ts, T1i)
            L1i = ccs_ops.L1inter(eris, ts, fsp[0])
            ls = ccs_ops.lsupdate(eris, ts, ls, L1i)

            def _vexp_mat(v):
                if v is None or np.isscalar(v):
                    return None
                return jnp.asarray(np.asarray(v, dtype=float))

            # diagonalization of the R1 (right) and es-L1 (left) maps in the
            # singles space.  The left vectors get their OWN eigensolve of
            # the transposed-similarity map (the reference runs a separate
            # non-symmetric Davidson for L, Solver_ES.py:746-761; aliasing
            # ln = rn is wrong for a non-symmetric matrix).
            for n in range(1, nbr_states):
                vexp_r = _vexp_mat(Vexp_class.Vexp[0, n])
                vexp_l = _vexp_mat(Vexp_class.Vexp[n, 0])
                if vexp_l is None:
                    vexp_l = vexp_r  # reference fallback (Solver_ES.py:738-741)
                Rinter = ccs_ops.R1inter(eris, ts, fsp[n], vexp_r)
                Fab, Fji, W, F, Tia, Pia = Rinter
                Li = ccs_ops.es_L1inter(eris, ts, fsp[n], vexp_l)
                Fba_l, Fij_l, W_l, F_l, Zia_l, P_l = Li

                if davidson:
                    # matrix-free Davidson; the reference-intended matvec
                    # carries the current r0/l0 affine terms along
                    # (Solver_ES.py:704-711) and preconditions with the
                    # exact map diagonal incl. the Vexp term
                    # (Solver_ES.py:697-702): Fab[bb] - Fji[jj] + W[b,j,j,b]
                    # + F + Pia[j,b].  W layout is [a,k,i,c] (R1eq contracts
                    # 'akic,kc->ia'), so the diagonal is W[b,j,j,b] -> 'bjjb'.
                    diag_W = np.einsum("bjjb->jb", np.asarray(W))
                    diag_r = (np.diag(np.asarray(Fab))[None, :]
                              - np.diag(np.asarray(Fji))[:, None]
                              + diag_W + float(F) + np.asarray(Pia)).ravel()
                    r0_cur = r0n[n - 1]

                    # device Davidson: intermediates
                    # ride as operands; STABLE matvec from the lru factory
                    # (the pipelined Davidson caches programs on its id)
                    matvec_r, _ = _diag_matvecs(nocc, nvir)
                    x0 = [np.ravel(np.asarray(rn[n - 1]))]
                    conv_dav, w_dav, xs = ulinalg.davidson_device(
                        matvec_r, x0, diag_r, nroots=1, max_space=max_space,
                        follow=True,
                        operands=(Rinter, jnp.asarray(r0_cur)))
                    Em = float(w_dav[0])
                    vec = np.asarray(xs[0])
                    vec = vec / np.linalg.norm(vec)
                    rn[n - 1] = jnp.asarray(vec.reshape(nocc, nvir))
                    r0n[n - 1] = float(ccs_ops.r0_fromE(eris, Em, ts, rn[n - 1],
                                                        vexp_r, fsp=fsp[n]))

                    # left diag: W_l layout is [b,i,j,a] (es_L1eq contracts
                    # 'jb,bija->ia'), diagonal element W_l[a,i,i,a] -> 'aiia'
                    diag_Wl = np.einsum("aiia->ia", np.asarray(W_l))
                    diag_l = (np.diag(np.asarray(Fba_l))[None, :]
                              - np.diag(np.asarray(Fij_l))[:, None]
                              + diag_Wl + float(F_l) + np.asarray(P_l)).ravel()
                    l0_cur = l0n[n - 1]

                    _, matvec_l = _diag_matvecs(nocc, nvir)
                    x0l = [np.ravel(np.asarray(ln[n - 1]))]
                    conv_dl, w_dl, xls = ulinalg.davidson_device(
                        matvec_l, x0l, diag_l, nroots=1, max_space=max_space,
                        follow=True, operands=(Li, jnp.asarray(l0_cur)))
                    Em_l = float(w_dl[0])
                    lvec = np.asarray(xls[0])
                    lvec = lvec / np.linalg.norm(lvec)
                    ln[n - 1] = jnp.asarray(lvec.reshape(nocc, nvir))
                    l0n[n - 1] = float(ccs_ops.l0_fromE(eris, Em_l, ts,
                                                        ln[n - 1], vexp_l,
                                                        fsp=fsp[n]))
                    Ep[n, 0] = Em
                    Ep[n, 1] = Em_l
                    continue

                # dense path: exact eigendecomposition of the linear part of
                # both maps, root followed by overlap with the current vector
                A = (jnp.einsum("ab,ij->iajb", Fab, jnp.eye(nocc))
                     - jnp.einsum("ji,ab->iajb", Fji, jnp.eye(nvir))
                     + jnp.einsum("akic->iakc", W).reshape(nocc, nvir, nocc, nvir))
                A = A.reshape(nov, nov) + F * jnp.eye(nov)
                w, vecs = np.linalg.eig(np.asarray(A))
                overlaps = np.abs(np.asarray(vecs).T @ np.ravel(np.asarray(rn[n - 1])))
                k = int(np.argmax(overlaps))
                Em = float(w[k].real)
                vec = np.real(vecs[:, k])
                vec = vec / np.linalg.norm(vec)
                rn[n - 1] = jnp.asarray(vec.reshape(nocc, nvir))
                r0n[n - 1] = float(ccs_ops.r0_fromE(eris, Em, ts, rn[n - 1],
                                                    vexp_r, fsp=fsp[n]))

                B = (jnp.einsum("ba,ij->iajb", Fba_l, jnp.eye(nocc))
                     - jnp.einsum("ij,ab->iajb", Fij_l, jnp.eye(nvir))
                     + jnp.einsum("bija->iajb", W_l))
                B = B.reshape(nov, nov) + F_l * jnp.eye(nov)
                wl, vecsl = np.linalg.eig(np.asarray(B))
                overlaps_l = np.abs(np.asarray(vecsl).T @ np.ravel(np.asarray(ln[n - 1])))
                kl = int(np.argmax(overlaps_l))
                Em_l = float(wl[kl].real)
                lvec = np.real(vecsl[:, kl])
                lvec = lvec / np.linalg.norm(lvec)
                ln[n - 1] = jnp.asarray(lvec.reshape(nocc, nvir))
                l0n[n - 1] = float(ccs_ops.l0_fromE(eris, Em_l, ts, ln[n - 1],
                                                    vexp_l, fsp=fsp[n]))
                Ep[n, 0] = Em
                Ep[n, 1] = Em_l

            Ep[0, 0] = float(ccs_ops.energy_ccs(eris, ts, fsp[0]))
            conv = np.asarray(ts) + np.asarray(ls)
            if ite > 0:
                Dconv = float(np.linalg.norm(conv - conv_old))
            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 30.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            Conv_text = f"Convergence reached for lambda= {L}, after {ite} iteration"

        dic_amp = {"ts": np.asarray(ts), "ls": np.asarray(ls),
                   "rn": [np.asarray(x) for x in rn],
                   "ln": [np.asarray(x) for x in ln], "r0n": r0n, "l0n": l0n}
        return Conv_text, dic_amp, Delta, Ep, np.asarray(rdm1_gs)


# ---------------------------------------------------------------------------
# Fully-jitted device path: one lax.while_loop for the coupled ES solve
# ---------------------------------------------------------------------------

_ES_DEVICE_PROPS = {"mat", "trmat", "Ek", "v1e", "dip", "DEk", "trdip", "F"}


class SolverES_Device:
    """lax.while_loop version of Solver_ES.SCF: all state/transition rdm1s,
    the full Vexp[n,m] refresh, the coupled t/lambda updates and the
    per-state (r, r0, l, l0) updates run inside ONE jitted while_loop, with
    the per-state work vmapped over the excited states.

    Construct with the same arguments as Solver_ES; call `SCF(L, ...)`.
    """

    def __init__(self, solver: "Solver_ES"):
        self.s = solver
        names = solver.Vexp_class.prop_names
        ok = all(p in _ES_DEVICE_PROPS for st in names for p in st)
        if not ok:
            raise NotImplementedError(
                "device ES solver supports mat/trmat/Ek/v1e/dip/DEk/trdip/F "
                "targets; use Solver_ES.SCF for others")
        from ecw_cc_tpu.ops.vexp import make_es_vexp_device

        self._vexp = make_es_vexp_device(solver.Vexp_class)
        self._runs = {}

    def _build(self, use_ov, force_alpha, diis):
        s = self.s
        nocc, nvir = s.nocc, s.nvir
        dim = s.dim
        n_states = s.nbr_states
        n_es = n_states - 1
        vexp_fn = self._vexp
        maxiter = s.maxiter
        thres = s.conv_thres
        conv_kind = s.conv_var
        hist = maxiter + 2
        mindiis = s.mindiis
        nov = nocc * nvir

        def conv_vec(ts, ls, rn, ln, Ep):
            if conv_kind == "Ep":
                return Ep.ravel()
            if conv_kind == "tl":
                return (ts + ls).ravel()
            if conv_kind == "rl":
                return jnp.sum(rn + ln, axis=0).ravel()
            return ((ts + ls) + jnp.sum(rn + ln, axis=0)).ravel()

        # eris is threaded through as a jit ARGUMENT (remote-compile gotcha:
        # closure-captured device arrays ship with the lowered program)
        def state_update(eris, ts, fspn, v0n, vn0, r, l, r0, l0, ov):
            Rinter = ccs_ops.R1inter(eris, ts, fspn, v0n)
            if use_ov:
                o, v = ov[0], ov[1]
                Em, o, v = ccs_ops.Extract_Em_r(eris, r, r0, Rinter, ov=(o, v))
            else:
                Em, o, v = ccs_ops.Extract_Em_r(eris, r, r0, Rinter)
            rnew = ccs_ops.rsupdate(eris, r, r0, Rinter, Em,
                                    force_alpha=force_alpha)
            rov = ccs_ops.get_ov(l, l0, r, r0, (o, v))
            rnew = rnew.at[o, v].set(rov)
            r0new = ccs_ops.r0_fromE(eris, Em, ts, r, v0n, fsp=fspn)

            Linter = ccs_ops.es_L1inter(eris, ts, fspn, vn0)
            if use_ov:
                o2, v2 = ov[0], ov[1]
                Em_l, o2, v2 = ccs_ops.Extract_Em_l(eris, l, l0, Linter,
                                                    ov=(o2, v2))
            else:
                Em_l, o2, v2 = ccs_ops.Extract_Em_l(eris, l, l0, Linter)
            lnew = ccs_ops.es_lsupdate(eris, l, l0, Em_l, Linter,
                                       force_alpha=force_alpha)
            lov = ccs_ops.get_ov(r, r0, l, l0, (o2, v2))
            lnew = lnew.at[o2, v2].set(lov)
            l0new = ccs_ops.l0_fromE(eris, Em_l, ts, l, vn0, fsp=fspn)
            return rnew, lnew, r0new, l0new, Em, Em_l

        def body(eris, carry):
            (ts, ls, rn, ln, r0n, l0n, ov, dstate, conv, Dconv, ite, k,
             status, Ep_h, Delta_h, Lflat) = carry
            conv_old = conv

            rdm1_gs = ccs_ops.gamma_CCS(ts, ls)
            rdm1_es = jax.vmap(
                lambda l_, r_, r0_, l0_: ccs_ops.gamma_es_CCS(ts, l_, r_, r0_, l0_)
            )(ln, rn, r0n, l0n)
            tr_r = jax.vmap(
                lambda l_, l0_: ccs_ops.gamma_tr_CCS(
                    ts, l_, jnp.zeros_like(ts), 1.0, l0_))(ln, l0n)
            tr_l = jax.vmap(
                lambda r_, r0_: ccs_ops.gamma_tr_CCS(ts, ls, r_, r0_, 1.0)
            )(rn, r0n)

            V00, Vnn, V0n, Vn0, Delta = vexp_fn(rdm1_gs, rdm1_es, tr_r, tr_l,
                                                Lflat)
            fsp0 = eris.fock - V00
            fspn = eris.fock[None] - Vnn

            T1i = ccs_ops.T1inter(eris, ts, fsp0)
            ts = ccs_ops.tsupdate(eris, ts, T1i, rsn=rn, r0n=r0n, vn=V0n)
            L1i = ccs_ops.L1inter(eris, ts, fsp0)
            ls = ccs_ops.lsupdate(eris, ts, ls, L1i, rsn=rn, lsn=ln, r0n=r0n,
                                  l0n=l0n, vn=Vn0)

            rnew, lnew, r0new, l0new, Em_r, Em_l = jax.vmap(
                lambda f_, v0_, vn_, r_, l_, r0_, l0_, ov_: state_update(
                    eris, ts, f_, v0_, vn_, r_, l_, r0_, l0_, ov_)
            )(fspn, V0n, Vn0, rn, ln, r0n, l0n, ov)

            if diis in ("ES", "all", "GS"):
                if diis == "GS":
                    vec = jnp.concatenate([ls.ravel(), ts.ravel()])
                elif diis == "ES":
                    vec = jnp.concatenate([rnew.ravel(), lnew.ravel(),
                                           r0new, l0new])
                else:
                    vec = jnp.concatenate([ts.ravel(), ls.ravel(),
                                           rnew.ravel(), lnew.ravel(),
                                           r0new, l0new])
                dstate, vec = diis_ops.diis_update(dstate, vec, mindiis)
                if diis == "GS":
                    ls = vec[:nov].reshape(nocc, nvir)
                    ts = vec[nov:].reshape(nocc, nvir)
                elif diis == "ES":
                    rnew = vec[:n_es * nov].reshape(n_es, nocc, nvir)
                    lnew = vec[n_es * nov:2 * n_es * nov].reshape(n_es, nocc, nvir)
                    r0new = vec[2 * n_es * nov:2 * n_es * nov + n_es]
                    l0new = vec[-n_es:]
                else:
                    ts = vec[:nov].reshape(nocc, nvir)
                    ls = vec[nov:2 * nov].reshape(nocc, nvir)
                    rnew = vec[2 * nov:2 * nov + n_es * nov].reshape(n_es, nocc, nvir)
                    lnew = vec[2 * nov + n_es * nov:2 * nov + 2 * n_es * nov
                               ].reshape(n_es, nocc, nvir)
                    r0new = vec[-2 * n_es:-n_es]
                    l0new = vec[-n_es:]

            rn, ln, r0n, l0n = rnew, lnew, r0new, l0new
            Ep0 = ccs_ops.energy_ccs(eris, ts, fsp0, rsn=rn, r0n=r0n, vn=V0n)
            Ep = jnp.zeros((n_states, 2), ts.dtype)
            Ep = Ep.at[0, 0].set(Ep0)
            Ep = Ep.at[1:, 0].set(Em_r)
            Ep = Ep.at[1:, 1].set(Em_l)

            conv = conv_vec(ts, ls, rn, ln, Ep)
            Dconv = jnp.where(ite > 0, jnp.linalg.norm(conv - conv_old), Dconv)
            Ep_h = Ep_h.at[k].set(Ep)
            Delta_h = Delta_h.at[k].set(Delta)
            status = jnp.where(ite >= maxiter, 2,
                               jnp.where(Dconv > 10.0, 3, status))
            ite = jnp.where(status == 0, ite + 1, ite)
            return (ts, ls, rn, ln, r0n, l0n, ov, dstate, conv, Dconv, ite,
                    k + 1, status, Ep_h, Delta_h, Lflat)

        def cond(carry):
            Dconv, status = carry[9], carry[12]
            return (Dconv > thres) & (status == 0)

        @jax.jit
        def run(eris, ts0, ls0, rn0, ln0, r0n0, l0n0, ov0, Lflat):
            if diis == "GS":
                nvec = 2 * nov
            elif diis == "ES":
                nvec = 2 * n_es * nov + 2 * n_es
            elif diis == "all":
                nvec = 2 * nov + 2 * n_es * nov + 2 * n_es
            else:
                nvec = 1
            dstate = diis_ops.diis_init(nvec, s.maxdiis, dtype=ts0.dtype)
            conv0 = jnp.zeros_like(conv_vec(
                ts0, ls0, rn0, ln0, jnp.zeros((n_states, 2), ts0.dtype)))
            carry = (ts0, ls0, rn0, ln0, r0n0, l0n0, ov0, dstate, conv0,
                     jnp.asarray(1.0, ts0.dtype), jnp.asarray(0, jnp.int32),
                     jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                     jnp.zeros((hist, n_states, 2), ts0.dtype),
                     jnp.zeros((hist, n_states, n_states), ts0.dtype), Lflat)
            out = jax.lax.while_loop(cond, lambda c: body(eris, c), carry)
            (ts, ls, rn, ln, r0n, l0n, _, _, _, Dconv, ite, k, status,
             Ep_h, Delta_h, _) = out
            status = jnp.where(status == 0, 1, status)
            rdm1_gs = ccs_ops.gamma_CCS(ts, ls)
            return (ts, ls, rn, ln, r0n, l0n, rdm1_gs, ite, k, status,
                    Ep_h, Delta_h)

        return run

    def SCF(self, L=None, dic_amp_ini=None, diis=None, force_alpha=True,
            print_ite=False):
        s = self.s
        Vexp_class = s.Vexp_class
        L = Vexp_class.L if L is None else Vexp_class.L_check(L)
        Lflat = jnp.asarray(np.concatenate([np.atleast_1d(x) for x in
                                            [np.asarray(st, float) for st in L]]))
        diis = s.diis if diis is None else diis

        if dic_amp_ini is None:
            ts = jnp.asarray(s.tsini)
            ls = jnp.asarray(s.lsini)
            rn = jnp.stack([jnp.asarray(r) for r in s.rn_ini])
            ln = jnp.stack([jnp.asarray(l) for l in s.ln_ini])
            r0n = jnp.asarray(s.r0_ini)
            l0n = jnp.asarray(s.l0_ini)
            ov = np.zeros((s.nbr_states - 1, 2), dtype=np.int32)
            for i, r in enumerate(s.rn_ini):
                w = np.argwhere(np.asarray(r) == 1)
                ov[i] = w[0] if len(w) else (0, 0)
            use_ov = True
        else:
            ts = jnp.asarray(dic_amp_ini["ts"])
            ls = jnp.asarray(dic_amp_ini["ls"])
            rn = jnp.stack([jnp.asarray(r) for r in dic_amp_ini["rn"]])
            ln = jnp.stack([jnp.asarray(l) for l in dic_amp_ini["ln"]])
            r0n = jnp.asarray(dic_amp_ini["r0n"])
            l0n = jnp.asarray(dic_amp_ini["l0n"])
            ov = np.zeros((s.nbr_states - 1, 2), dtype=np.int32)
            use_ov = False

        key = (use_ov, force_alpha, diis)
        if key not in self._runs:
            self._runs[key] = self._build(use_ov, force_alpha, diis)
        out = self._runs[key](s.mycc.eris, ts, ls, rn, ln, r0n, l0n,
                              jnp.asarray(ov), Lflat)
        # ONE batched transfer (each np.asarray is its own round trip)
        (ts, ls, rn, ln, r0n, l0n, rdm1_gs, ite, k, status,
         Ep_h, Delta_h) = jax.device_get(out)
        n = int(k)
        if status == 1:
            text = f"Convergence reached for lambda= {L}, after {int(ite)} iteration"
        elif status == 2:
            text = "Max iteration reached"
        else:
            text = f"Diverges for lambda = {L} after {int(ite)} iterations"
        dic_amp = {"ts": ts, "ls": ls, "rn": list(rn), "ln": list(ln),
                   "r0n": list(r0n), "l0n": list(l0n)}
        Ep = Ep_h[n - 1] if n else Ep_h[0]
        Delta = Delta_h[n - 1] if n else Delta_h[0]
        from ecw_cc_tpu.solvers.gs import _record_metrics
        _record_metrics(self, "ES_device", L if np.isscalar(L) else 0.0,
                        Ep_h[:n, 0, 0], Delta_h[:n, 0, 0], [])
        return text, dic_amp, Delta, Ep, rdm1_gs
