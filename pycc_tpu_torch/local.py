"""Local-correlation machinery: PAO / PNO / PNO++ / CPNO++ virtual spaces.

The counterpart of pycc_tpu/local.py.  The per-pair truncated spaces are
built on the host in numpy, pair by pair, with pycc_tpu's own steps
(LAPACK `eigh` per pair, the same truncation test, the ij -> ji copy of
`_match_phases`), so each pair keeps the dimension pycc_tpu gives it.
They are then stored as zero-padded stacks on the device: Q (no^2, nv,
D1; canonical virtual -> local), L (no^2, D1, D2; local ->
semicanonical local), the semicanonical energies eps (no^2, D2), padded
with the sentinel `_EPS_PAD`, and QL = Q L (no^2, nv, D2).  The
amplitude and residual filters (`filter_amps`, `filter_res`,
`filter_t2amps`) are batched matrix products over those stacks on the
device.  A padded slot is exactly zero after every filter: its Q column
and L row are zero, and the sentinel keeps its denominator finite.

`Local.from_numpy` builds the stacks from pycc_tpu's padded arrays, so a
test can hold both packages to one space: PNO and semicanonical vectors
are defined only up to sign (and within degenerate subspaces), which
LAPACK and cuSOLVER need not agree on.
"""

import numpy as np
import torch

from .ops.contract import contract
from .utils.log import logger as log

_EPS_PAD = 1.0e8


def _np(x):
    """x as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sandwich(A, X, B):
    """A^T X B over a leading batch, for real stacks A, B and a real or
    complex X: the filter is real-linear, so a complex X is filtered by
    its real and imaginary parts."""
    if X.is_complex():
        return torch.complex(_sandwich(A, X.real, B), _sandwich(A, X.imag, B))
    dt = torch.promote_types(X.dtype, A.dtype)
    return A.mT.to(dt) @ X.to(dt) @ B.to(dt)


def _bsandwich(A, X, B):
    """A X B^T over a leading batch (the back transform of `_sandwich`)."""
    if X.is_complex():
        return torch.complex(_bsandwich(A, X.real, B),
                             _bsandwich(A, X.imag, B))
    dt = torch.promote_types(X.dtype, A.dtype)
    return A.to(dt) @ X.to(dt) @ B.mT.to(dt)


class Local:
    """The local virtual spaces of one localized Hamiltonian H (a
    pycc_tpu_torch Hamiltonian on its device), and their filters."""

    def __init__(self, local, C, nfzc, no, nv, H, cutoff, it2_opt,
                 wfn=None, core_cut=5e-2, lindep_cut=1e-6,
                 e_conv=1e-12, r_conv=1e-12):
        self.cutoff = cutoff
        self.nfzc = nfzc
        self.no = no
        self.nv = nv
        self.H = H
        self.C = np.asarray(C)
        self.local = local
        self.it2_opt = it2_opt
        self.wfn = wfn
        self.core_cut = core_cut
        self.lindep_cut = lindep_cut
        self.e_conv = e_conv
        self.r_conv = r_conv
        self.device = H.F.device

        self._build()
        self._stack()

    @classmethod
    def from_numpy(cls, Qp, Lp, epsp, dim, H, no, nv, local="PNO",
                   cutoff=None):
        """A Local over given padded stacks (numpy: Qp (no^2, nv, D1), Lp
        (no^2, D1, D2), epsp (no^2, D2), dim (no^2,)), e.g. pycc_tpu's
        `Local.Qp/Lp/epsp/dim`, carried onto H's device."""
        self = cls.__new__(cls)
        self.local, self.cutoff = local, cutoff
        self.e_conv = self.r_conv = 1e-12
        self.no, self.nv, self.H = no, nv, H
        self.device = H.F.device
        self.dim = np.asarray(dim)
        self._set_padded(np.asarray(Qp), np.asarray(Lp), np.asarray(epsp))
        return self

    # ------------------------------------------------------------------
    def _build(self):
        kind = self.local.upper()
        if kind == "PNO":
            self._build_PNO()
        elif kind == "PAO":
            self._build_PAO()
        elif kind == "PNO++":
            self._build_PNOpp()
        elif kind == "CPNO++":
            self._build_cPNOpp()
        else:
            raise ValueError("Not a valid local type!")

    def _host_blocks(self):
        """F, the oovv block of ERI and of L, on the host."""
        no, nv = self.no, self.nv
        o, v = slice(0, no), slice(no, no + nv)
        return (_np(self.H.F), _np(self.H.ERI[o, o, v, v]),
                _np(self.H.L[o, o, v, v]))

    # ------------------------------------------------------------------
    def _mp2_t2(self):
        no, nv = self.no, self.nv
        o, v = slice(0, no), slice(no, no + nv)
        F, Eoovv, Loovv = self._host_blocks()
        eps_o = np.diag(F)[o]
        eps_v = np.diag(F)[v]
        Dijab = (eps_o[:, None, None, None] + eps_o[None, :, None, None]
                 - eps_v[None, None, :, None] - eps_v[None, None, None, :])
        t2 = Eoovv / Dijab
        if self.it2_opt:
            # non-canonical MP2 (Hylleraas minimization)
            emp2 = np.einsum("ijab,ijab->", t2, Loovv)
            for niter in range(200):
                elast = emp2
                r2 = 0.5 * Eoovv.copy()
                r2 += np.einsum("ijae,be->ijab", t2, F[v, v])
                r2 -= np.einsum("imab,mj->ijab", t2, F[o, o])
                r2 = r2 + r2.transpose(1, 0, 3, 2)
                t2 = t2 + r2 / Dijab
                rmsd = np.sqrt(np.einsum("ijab,ijab->", r2 / Dijab,
                                         r2 / Dijab))
                emp2 = np.einsum("ijab,ijab->", t2, Loovv)
                if abs(emp2 - elast) < self.e_conv and rmsd < self.r_conv:
                    break
        return t2

    def _pairdensity(self, t_ijab):
        no, nv = self.no, self.nv
        T = np.asarray(t_ijab).reshape(no * no, nv, nv)
        Tt = 2.0 * T - T.swapaxes(1, 2)
        D = np.zeros((no * no, nv, nv))
        for ij in range(no * no):
            i, j = ij // no, ij % no
            d = T[ij] @ Tt[ij].T + T[ij].T @ Tt[ij]
            d = d * (2.0 / (1.0 + int(i == j)))
            D[ij] = 0.5 * (d + d.T)
        return D

    def _pert_pairdensity(self, t2):
        """Perturbed (dipole) pair density for PNO++."""
        no, nv = self.no, self.nv
        o, v = slice(0, no), slice(no, no + nv)
        F, _, Loovv = self._host_blocks()
        Hbar_ii = (F[o, o] + np.einsum("inef,mnef->mi", t2, Loovv)).diagonal()
        Hbar_aa = (F[v, v] - np.einsum("mnfa,mnfe->ae", t2, Loovv)).diagonal()
        denom_ijab = (Hbar_ii[:, None, None, None]
                      + Hbar_ii[None, :, None, None]
                      - Hbar_aa[None, None, :, None]
                      - Hbar_aa[None, None, None, :])
        D = np.zeros((no * no, nv, nv))
        for ax in range(3):
            A = _np(self.H.mu[ax])
            Avvoo = np.einsum("ijeb,ae->abij", t2, A[no:, no:])
            Avvoo -= np.einsum("mjab,mi->abij", t2, A[:no, :no])
            Abar = Avvoo.transpose(2, 3, 0, 1)
            Abar = Abar + Abar.transpose(1, 0, 3, 2)
            X = Abar / denom_ijab
            D += self._pairdensity(X)
        return D / 3.0

    def _QL_tensors(self, t2, D):
        no, nv = self.no, self.nv
        F = _np(self.H.F)
        v = slice(no, no + nv)
        Q, L, eps = [], [], []
        dim = np.zeros(no * no, dtype=int)
        for ij in range(no * no):
            occ, Qf = np.linalg.eigh(D[ij])
            dim[ij] = int((np.abs(occ) > self.cutoff).sum())
            q = Qf[:, nv - dim[ij]:]
            Q.append(q)
            Floc = q.T @ F[v, v] @ q
            ev, evec = np.linalg.eigh(Floc)
            eps.append(ev)
            L.append(evec)
        log.info("Average %s dimension: %2.3f" % (self.local, np.average(dim)))
        return Q, L, eps, dim

    def _match_phases(self):
        no = self.no
        for i in range(no):
            for j in range(i):
                ij = i * no + j
                ji = j * no + i
                self.Q[ji] = self.Q[ij]
                self.L[ji] = self.L[ij]
                self.eps[ji] = self.eps[ij]
                self.dim[ji] = self.dim[ij]

    def _build_PNO(self):
        t2 = self._mp2_t2()
        D = self._pairdensity(t2)
        self.Q, self.L, self.eps, self.dim = self._QL_tensors(t2, D)
        self._match_phases()

    def _build_PNOpp(self):
        t2 = self._mp2_t2()
        D = self._pert_pairdensity(t2)
        self.Q, self.L, self.eps, self.dim = self._QL_tensors(t2, D)
        self._match_phases()

    def _build_cPNOpp(self):
        """QR-combined PNO + PNO++ spaces."""
        no, nv = self.no, self.nv
        F = _np(self.H.F)
        v = slice(no, no + nv)
        self._build_PNO()
        Q_PNO = self.Q
        self._build_PNOpp()
        Q_PNOpp = self.Q
        Q, L, eps = [], [], []
        dim = np.zeros(no * no, dtype=int)
        for ij in range(no * no):
            Q_comb = np.hstack((Q_PNO[ij], Q_PNOpp[ij]))
            Q_ortho, _ = np.linalg.qr(Q_comb)
            Q.append(Q_ortho)
            Floc = Q_ortho.T @ F[v, v] @ Q_ortho
            ev, evec = np.linalg.eigh(Floc)
            eps.append(ev)
            L.append(evec)
            dim[ij] = Q_ortho.shape[1]
        self.Q, self.L, self.eps, self.dim = Q, L, eps, dim
        self._match_phases()

    def _build_PAO(self):
        """Projected atomic orbitals with Boughton-Pulay domains (Hampel &
        Werner 1996)."""
        no, nv, nfzc = self.no, self.nv, self.nfzc
        wfn = self.wfn
        basis = wfn.basisset()
        S = np.asarray(wfn.S_ao)
        C_all = np.asarray(wfn.Ca())
        F_ao = np.asarray(wfn.Fa())
        no_all = no + nfzc
        nao = no + nv + nfzc
        Dmat = C_all[:, :no_all] @ C_all[:, :no_all].T

        # atom -> AO indices
        natom = basis.molecule.natom
        a2ao = {A: [] for A in range(natom)}
        for sh, off in zip(basis.shells, basis.offsets):
            a2ao[sh.atom_index].extend(range(off, off + sh.nfunc))

        atom_domains, AO_domains = [], []
        for i in range(no):
            charges = np.zeros(natom)
            SC = S @ self.C[:, i]
            for A in range(natom):
                idx = a2ao[A]
                charges[A] = np.sum(self.C[idx, i] * SC[idx])
            order = list(np.argsort(-np.abs(charges)))
            atom_domains.append([order.pop(0)])
            AOi = sorted(sum((a2ao[A] for A in atom_domains[i]), []))
            chk = 1.0
            while chk > self.cutoff:
                A = S[np.ix_(AOi, AOi)]
                SB = S[AOi, :]
                Bvec = SB @ self.C[:, i]
                Rp = np.linalg.solve(A, Bvec)
                chk = 1 - Rp @ SB @ self.C[:, i]
                if chk > self.cutoff:
                    if not order:
                        if self.cutoff == 0:
                            chk = 0
                            continue
                        raise IndexError("Ran out of atoms in PAO domain build")
                    n = order.pop(0)
                    atom_domains[i].append(n)
                    AOi = sorted(AOi + a2ao[n])
            AO_domains.append(AOi)

        Rt_full = np.eye(S.shape[0]) - Dmat @ S
        for i in range(nao):
            if np.linalg.norm(Rt_full[:, i]) < self.core_cut:
                Rt_full[:, i] = 0
        RS = self.C[:, no:].T @ S

        Q, L, eps = [], [], []
        dim = np.zeros(no * no, dtype=int)
        for ij in range(no * no):
            i, j = ij // no, ij % no
            ij_domain = sorted(set(AO_domains[i] + AO_domains[j]))
            Rt = Rt_full[:, ij_domain]
            Q.append(RS @ Rt)
            St = Rt.T @ S @ Rt
            evals, evecs = np.linalg.eigh(St)
            toss = np.abs(evals) < self.lindep_cut
            Xt = evecs[:, ~toss] / np.sqrt(evals[~toss])
            dim[ij] = Xt.shape[1]
            Ft = Rt.T @ F_ao @ Rt
            Fbar = Xt.T @ Ft @ Xt
            evals, evecs = np.linalg.eigh(Fbar)
            W = Xt @ evecs
            eps.append(evals)
            L.append(W)
        log.info("Average PAO dimension: %.2f" % np.average(dim))
        self.Q, self.L, self.eps, self.dim = Q, L, eps, dim

    # ------------------------------------------------------------------
    # padded stacks and the batched filters
    # ------------------------------------------------------------------
    def _stack(self):
        """Zero-pad the ragged per-pair lists into stacks, pycc_tpu's
        layout, and carry them onto the device."""
        npair = self.no * self.no
        D1 = max(q.shape[1] for q in self.Q)
        D2 = max(l.shape[1] for l in self.L)
        Qp = np.zeros((npair, self.nv, D1))
        Lp = np.zeros((npair, D1, D2))
        epsp = np.full((npair, D2), _EPS_PAD)
        for ij in range(npair):
            d1 = self.Q[ij].shape[1]
            d2 = self.L[ij].shape[1]
            Qp[ij, :, :d1] = self.Q[ij]
            Lp[ij, :d1, :d2] = self.L[ij]
            epsp[ij, :d2] = self.eps[ij]
        self._set_padded(Qp, Lp, epsp)

    def _set_padded(self, Qp, Lp, epsp):
        no = self.no
        dev = self.device
        f64 = torch.float64
        self.Qp = torch.tensor(Qp, dtype=f64, device=dev)
        self.Lp = torch.tensor(Lp, dtype=f64, device=dev)
        self.epsp = torch.tensor(epsp, dtype=f64, device=dev)
        self.D1, self.D2 = Qp.shape[2], Lp.shape[2]
        # the combined canonical-virtual -> semicanonical-local transform
        self.QLp = self.Qp @ self.Lp
        fo = torch.diagonal(self.H.F)[:no]
        self._fo = fo
        ii = torch.arange(no, device=dev) * (no + 1)
        self._ii = ii
        pair = torch.arange(no * no, device=dev)
        self._pair_i, self._pair_j = pair // no, pair % no
        # pair denominators fo_i + fo_j - eps_a - eps_b and the singles'
        # fo_i - eps_a in the semicanonical pair bases (padded slots carry
        # the sentinel, so they divide to zero)
        self._D2p = (fo[self._pair_i][:, None, None]
                     + fo[self._pair_j][:, None, None]
                     - self.epsp[:, :, None] - self.epsp[:, None, :])
        self._D1p = fo[:, None] - self.epsp[ii]

    def _project2(self, r2, denom):
        no, nv = self.no, self.nv
        r2f = r2.reshape(no * no, nv, nv)
        Y = _sandwich(self.Lp, _sandwich(self.Qp, r2f, self.Qp), self.Lp)
        if denom:
            Y = Y / self._D2p
        X = _bsandwich(self.Lp, Y, self.Lp)
        return _bsandwich(self.Qp, X, self.Qp).reshape(no, no, nv, nv)

    def _project1(self, r1, denom):
        QLii = self.QLp[self._ii]
        Y = contract("iva,iv->ia", QLii, r1)
        if denom:
            Y = Y / self._D1p
        return contract("iva,ia->iv", QLii, Y)

    def filter_amps(self, r1, r2):
        """The Jacobi step of the local solve: each pair's residual
        projected into its semicanonical space, divided by the pair
        denominators, and back-transformed."""
        return self._project1(r1, True), self._project2(r2, True)

    def filter_res(self, r1, r2):
        """The residuals projected onto the pair spaces (no denominator)."""
        return self._project1(r1, False), self._project2(r2, False)

    def filter_t2amps(self, r2):
        return self._project2(r2, True)

    # ------------------------------------------------------------------
    def trans_integrals(self, o, v):
        """The local-basis integral blocks the native solver indexes
        (padded)."""
        no, nv = self.no, self.nv
        QLp = self.QLp
        F = self.H.F
        self.Fov_loc = contract("ov,pvb->pob", F[o, v], QLp)
        self.Fvv_loc = QLp.mT @ F[v, v] @ QLp
        ERIoovv = self.H.ERI[o, o, v, v].reshape(no * no, nv, nv)
        self.ERIoovv_loc = _sandwich(QLp, ERIoovv, QLp)
        Loovv = self.H.L[o, o, v, v].reshape(no * no, nv, nv)
        self.Loovv_loc = _sandwich(QLp, Loovv, QLp)

    def overlaps(self):
        """Pair-pair overlap stack S[ij, kl] = QL_ij^T QL_kl (padded)."""
        self.Sp = contract("pva,qvb->pqab", self.QLp, self.QLp)

    # ------------------------------------------------------------------
    # DLPNO-MP2 (Pinski, Riplinger, Valeev et al. 2015, Eqn. 13)
    # ------------------------------------------------------------------
    def local_mp2(self, maxiter=100, e_conv=None, r_conv=None):
        """Iterative local MP2 in the truncated semicanonical pair spaces,
        as pycc_tpu's: one batched residual over the padded stacks, whose
        couplings are two contractions against the (no, no, no, D2, D2)
        shared-index overlap stacks S_{ij,kj} and S_{ij,ik} (the
        off-diagonal occupied Fock; the diagonal is in the denominator).

        Returns (emp2, e_pair, t2loc): the converged local-MP2 energy, the
        (no, no) pair-energy matrix on the host, and the padded
        local-basis amplitudes (no, no, D2, D2)."""
        e_conv = self.e_conv if e_conv is None else e_conv
        r_conv = self.r_conv if r_conv is None else r_conv
        no, nv, D2 = self.no, self.nv, self.D2
        o, v = slice(0, no), slice(no, no + nv)
        QLp = self.QLp
        G = QLp.reshape(no, no, nv, D2)
        ERIoovv = self.H.ERI[o, o, v, v].reshape(no * no, nv, nv)
        ERIl = _sandwich(QLp, ERIoovv, QLp).reshape(no, no, D2, D2)
        fo = self._fo
        Focc = self.H.F[o, o]
        F_od = Focc - torch.diag(torch.diagonal(Focc))
        epsij = self.epsp.reshape(no, no, D2)
        De = (epsij[:, :, :, None] + epsij[:, :, None, :]
              - fo[:, None, None, None] - fo[None, :, None, None])
        S_kj = contract("ijva,kjvb->ijkab", G, G)
        S_ik = contract("ijva,ikvb->ijkab", G, G)

        def step(T):
            r = ERIl + De * T
            r = r - contract("ik,ijkar,kjrs,ijkbs->ijab", F_od, S_kj, T, S_kj)
            r = r - contract("kj,ijkar,ikrs,ijkbs->ijab", F_od, S_ik, T, S_ik)
            Tn = T - r / De
            Tt = 2.0 * Tn - Tn.swapaxes(2, 3)
            e_pair = contract("ijab,ijab->ij", ERIl, Tt)
            return Tn, e_pair, torch.sum(r * r)

        T = -ERIl / De
        e_pair = contract("ijab,ijab->ij", ERIl, 2.0 * T - T.swapaxes(2, 3))
        emp2 = float(torch.sum(e_pair))
        log.info("LMP2 Iter %3d: LMP2 Ecorr = %.15f" % (0, emp2))
        for niter in range(1, maxiter + 1):
            elast = emp2
            T, e_pair, rr = step(T)
            emp2, rmsd = torch.stack([torch.sum(e_pair),
                                      torch.sqrt(rr)]).tolist()
            log.info("LMP2 Iter %3d: LMP2 Ecorr = %.15f  dE = % .5E  "
                     "rmsd = % .5E" % (niter, emp2, emp2 - elast, rmsd))
            if abs(emp2 - elast) < e_conv and rmsd < r_conv:
                break
        return emp2, _np(e_pair), T

    def sim_mp2(self, maxiter=100, e_conv=None, r_conv=None):
        """Simulation-path local MP2: the full-space residual iterated with
        every update projected through the pair filters.  Its fixed point
        is that of `local_mp2`, so the two converged energies agreeing is
        the pair of methods testing each other."""
        e_conv = self.e_conv if e_conv is None else e_conv
        r_conv = self.r_conv if r_conv is None else r_conv
        no, nv = self.no, self.nv
        o, v = slice(0, no), slice(no, no + nv)
        F = self.H.F
        ERI = self.H.ERI[o, o, v, v]
        Lt = self.H.L[o, o, v, v]

        def step(t2):
            r2 = 0.5 * ERI
            r2 = r2 + contract("ijae,be->ijab", t2, F[v, v])
            r2 = r2 - contract("imab,mj->ijab", t2, F[o, o])
            r2 = r2 + r2.permute(1, 0, 3, 2)
            dt = self.filter_t2amps(r2)
            t2n = t2 + dt
            return t2n, contract("ijab,ijab->", t2n, Lt), torch.sum(dt * dt)

        t2 = self.filter_t2amps(ERI)
        emp2 = float(contract("ijab,ijab->", t2, Lt))
        log.info("simMP2 Iter %3d: MP2 Ecorr = %.15f" % (0, emp2))
        for niter in range(1, maxiter + 1):
            elast = emp2
            t2, e, rr = step(t2)
            emp2, rmsd = torch.stack([e, torch.sqrt(rr)]).tolist()
            log.info("simMP2 Iter %3d: MP2 Ecorr = %.15f  dE = % .5E  "
                     "rmsd = % .5E" % (niter, emp2, emp2 - elast, rmsd))
            if abs(emp2 - elast) < e_conv and rmsd < r_conv:
                break
        return emp2, t2
