"""EOM-CCSD: the right-hand Davidson eigensolver over HBAR.

The counterpart of pycc_tpu/cceom.py for storage='full', 'blocked' and
'df'.  The
sigma builds take a block of k vectors at once: every term is one batched
contraction over the block, and the Hvvvv ladder is one K1 launch for the
block, its k stacked C2 as a (k o^2, v^2) matrix, before the pair
symmetrisation.  Over DF factors the sigma is models/dfhbar's
sigma1_df/sigma2_df over the block (`sigma_block_df`): W is assembled once
an a-block for the whole block, and the ladder is one K1 launch an
a-block, (k o^2, blk v, v^2).  The Davidson subspace C and its sigma block
S stay on the device; the host sees only the (M, M) Gram matrix, the
residual norms and the eigenvectors of the subspace
problem.  `dense_matrix` builds the whole EOM-CCSD matrix from sigmas, the
tests' oracle on small systems.  `solve_eom(chk=..., resume=...)`
checkpoints the subspace on the host; `solve_eom_mixed` runs a float32
Davidson and refines its Ritz vectors in float64.
"""

import os
import time
import warnings

import numpy as np
import torch

from .models.blocked import LoovvOnly, eri_views
from .models.ccsd import pair_symmetric, slices, vvvv_contract
from .models.dfhbar import DFHBar, loovv_df, sigma1_df, sigma2_df
from .ops.contract import contract
from .ops.kernels.vvvv import vvvv_nt
from .utils.log import logger as log

HARTREE2EV = 27.211386245988

def _sigma1(hb, C1, C2, Loovv):
    """Singles sigma of a block: C1 (k, o, v), C2 (k, o, o, v, v)."""
    s1 = contract("Kie,ae->Kia", C1, hb.Hvv)
    s1 -= contract("mi,Kma->Kia", hb.Hoo, C1)
    s1 += 2.0 * contract("maei,Kme->Kia", hb.Hovvo, C1)
    s1 -= contract("maie,Kme->Kia", hb.Hovov, C1)
    s1 += 2.0 * contract("Kmiea,me->Kia", C2, hb.Hov)
    s1 -= contract("Kimea,me->Kia", C2, hb.Hov)
    s1 += 2.0 * contract("Kimef,amef->Kia", C2, hb.Hvovv)
    s1 -= contract("Kimef,amfe->Kia", C2, hb.Hvovv)
    s1 -= 2.0 * contract("mnie,Kmnae->Kia", hb.Hooov, C2)
    s1 += contract("nmie,Kmnae->Kia", hb.Hooov, C2)
    return s1


def _sigma2_rest(hb, C1, C2, Loovv, t2):
    """Doubles sigma of a block without the Hvvvv ladder, before the pair
    symmetrisation."""
    Zvv = 2.0 * contract("amef,Kmf->Kae", hb.Hvovv, C1)
    Zvv -= contract("amfe,Kmf->Kae", hb.Hvovv, C1)
    Zvv -= contract("Knmaf,nmef->Kae", C2, Loovv)

    Zoo = -2.0 * contract("mnie,Kne->Kmi", hb.Hooov, C1)
    Zoo += contract("nmie,Kne->Kmi", hb.Hooov, C1)
    Zoo -= contract("mnef,Kinef->Kmi", Loovv, C2)

    s2 = contract("Kie,abej->Kijab", C1, hb.Hvvvo)
    s2 -= contract("mbij,Kma->Kijab", hb.Hovoo, C1)
    s2 += contract("ijeb,Kae->Kijab", t2, Zvv)
    s2 += contract("Kmi,mjab->Kijab", Zoo, t2)
    s2 += contract("Kijeb,ae->Kijab", C2, hb.Hvv)
    s2 -= contract("mi,Kmjab->Kijab", hb.Hoo, C2)
    s2 += 0.5 * contract("mnij,Kmnab->Kijab", hb.Hoooo, C2)
    s2 -= contract("Kimeb,maje->Kijab", C2, hb.Hovov)
    s2 -= contract("Kimea,mbej->Kijab", C2, hb.Hovvo)
    s2 += 2.0 * contract("Kmiea,mbej->Kijab", C2, hb.Hovvo)
    s2 -= contract("Kmiea,mbje->Kijab", C2, hb.Hovov)
    return s2


def sigma1(hb, C1, C2, L, no):
    """Singles sigma of one vector (C1 (o, v), C2 (o, o, v, v))."""
    o, v = slices(no)
    return _sigma1(hb, C1[None], C2[None], L[o, o, v, v])[0]


def sigma2(hb, C1, C2, L, t2, no):
    """Doubles sigma of one vector, its ladder through K1."""
    o, v = slices(no)
    s2 = _sigma2_rest(hb, C1[None], C2[None], L[o, o, v, v], t2)[0]
    s2 += 0.5 * vvvv_contract(C2, hb.Hvvvv)
    return s2 + s2.permute(1, 0, 3, 2)


def sigma_block(hb, C, L, t2, no, ladder=vvvv_nt):
    """sigma = HBAR C for a (k, dim) block of vectors [C1 | C2] (rows).
    The ladder 'ijef,abef->ijab' of all k vectors is one call of
    `ladder(A, B)` = A @ B.T: K1 by default; the plain `vvvv_nt_reference`
    gives the same sigma without the kernel."""
    k, nv = C.shape[0], t2.shape[2]
    n1 = no * nv
    o, v = slices(no)
    Loovv = L[o, o, v, v]
    C1 = C[:, :n1].reshape(k, no, nv)
    C2 = C[:, n1:].reshape(k, no, no, nv, nv)
    s1 = _sigma1(hb, C1, C2, Loovv)
    s2 = _sigma2_rest(hb, C1, C2, Loovv, t2)
    lad = ladder(C[:, n1:].reshape(k * no * no, nv * nv),
                 hb.Hvvvv.reshape(nv * nv, nv * nv))
    s2 += 0.5 * lad.reshape(k, no, no, nv, nv)
    s2 = s2 + s2.permute(0, 2, 1, 4, 3)
    return torch.cat([s1.reshape(k, n1), s2.reshape(k, n1 * n1)], dim=1)


def sigma_block_df(dfh, C, Loovv, t1, t2, no, nblocks=None,
                   ladder=vvvv_nt):
    """sigma = HBAR C for a (k, dim) block of vectors over the DF-HBAR
    (models/dfhbar.DFHBar): sigma1_df and sigma2_df over the block, whose
    ladder is one call of `ladder(A, B)` = A @ B.T an a-block for all k
    vectors (K1 by default; `vvvv_nt_reference` for the plain sigma)."""
    k, nv = C.shape[0], t2.shape[2]
    n1 = no * nv
    C1 = C[:, :n1].reshape(k, no, nv)
    C2 = C[:, n1:].reshape(k, no, no, nv, nv)
    s1 = sigma1_df(dfh, C1, C2, Loovv, no)
    s2 = sigma2_df(dfh, C1, C2, Loovv, t1, t2, no, nblocks=nblocks,
                   ladder=ladder)
    return torch.cat([s1.reshape(k, n1), s2.reshape(k, n1 * n1)], dim=1)


class cceom:
    """EOM-CCSD Davidson solver over a cchbar of a storage='full',
    'blocked' or 'df' ccwfn, on the ccwfn's device."""

    def __init__(self, cchbar):
        cc = cchbar.ccwfn
        self.hbar = cchbar
        self.ccwfn = cc
        self.no, self.nv = cc.no, cc.nv
        hb = cchbar.hbar
        # the DF sigma reads L[o,o,v,v] assembled from the factors once,
        # the dense sigma L[o,o,v,v] of the full or the blocked L
        self._df = isinstance(hb, DFHBar)
        if self._df:
            self._Loovv = loovv_df(hb.df)
        else:
            o, v = slices(self.no)
            self._Loovv = eri_views(cc)[1][o, o, v, v]
        occ = torch.diagonal(hb.Hoo)
        vir = torch.diagonal(hb.Hvv)
        Dia = occ[:, None] - vir[None, :]
        Dijab = (occ[:, None, None, None] + occ[None, :, None, None]
                 - vir[None, None, :, None] - vir[None, None, None, :])
        self.D = torch.cat([Dia.reshape(-1), Dijab.reshape(-1)])

    # the closed-shell sigma maps doubles symmetric under (ij)(ab) to
    # symmetric ones, and every singlet root lies in that subspace, while
    # it nearly annihilates the antisymmetric part: roundoff there (float32
    # seeds, the preconditioner's) grew into spurious roots near 0 in a
    # mixed (H2O)_6/cc-pVDZ refinement.  The Davidson keeps its vectors in
    # the subspace.
    pair_symmetric = True

    def _in_subspace(self, V):
        """V, a (k, dim) block of vectors, with its doubles made
        pair-symmetric in place (when `pair_symmetric`)."""
        if self.pair_symmetric:
            n1 = self.no * self.nv
            V2 = V[:, n1:].view(-1, self.no, self.no, self.nv, self.nv)
            V2.copy_(pair_symmetric(V2))
        return V

    def sigma(self, C, ladder=vvvv_nt):
        """sigma of a (k, dim) block of vectors on the device (one K1
        launch, or one an a-block over DF factors); see `sigma_block` and
        `sigma_block_df`."""
        cc = self.ccwfn
        with cc.timers.time("eom.sigma"):
            if self._df:
                return sigma_block_df(self.hbar.hbar, C, self._Loovv, cc.t1,
                                      cc.t2, self.no,
                                      nblocks=getattr(cc, "df_nblocks", None),
                                      ladder=ladder)
            return sigma_block(self.hbar.hbar, C,
                               LoovvOnly(self._Loovv, self.no), cc.t2,
                               self.no, ladder=ladder)

    def dense_matrix(self):
        """The full EOM-CCSD matrix as a host array (test oracle; small
        systems)."""
        n = self.D.numel()
        cols = []
        bs = 256
        for i in range(0, n, bs):
            b = min(bs, n - i)
            E = torch.zeros((b, n), dtype=self.D.dtype, device=self.D.device)
            E[torch.arange(b), i + torch.arange(b)] = 1.0
            cols.append(self.sigma(E).cpu().numpy())
        return np.concatenate(cols, axis=0).T

    def guess(self, M, method):
        """The M lowest singles-space guesses (host arrays): 'UNIT' (unit
        vectors at the largest denominators, as pycc_tpu picks them), 'CIS'
        or 'HBAR_SS' (the singles-singles block of HBAR)."""
        hbar = self.hbar
        no, nv = self.no, self.nv
        D1 = self.D[:no * nv].cpu().numpy()
        method = method.upper()
        if method == "UNIT":
            idx = D1.argsort()[::-1][:M]
            c = np.eye(no * nv)[:, idx]
            eps = np.sort(D1)[::-1]
        elif method == "CIS":
            cc = self.ccwfn
            F = cc.H.F.cpu().numpy()
            o, v = slices(no)
            if self._df:
                # L[a,i,j,b] = 2 (aj|ib) - (ab|ij) from the factors
                df = cc.dfb
                L_voov = (2.0 * torch.einsum("Pja,Pib->aijb", df.Bov, df.Bov)
                          - torch.einsum("Pab,Pij->aijb", df.Bvv, df.Boo))
            else:
                L_voov = eri_views(cc)[1][v, o, o, v]
            L_voov = L_voov.cpu().numpy()
            H = L_voov.swapaxes(0, 1).swapaxes(0, 2).copy()
            H += np.einsum("ab,ij->iajb", F[no:, no:][:nv, :nv], np.eye(no))
            H -= np.einsum("ij,ab->iajb", F[:no, :no], np.eye(nv))
            eps, c = np.linalg.eigh(H.reshape(no * nv, no * nv))
        elif method == "HBAR_SS":
            Hovvo = hbar.Hovvo.cpu().numpy()
            Hovov = hbar.Hovov.cpu().numpy()
            H = (2.0 * Hovvo.swapaxes(1, 2).swapaxes(2, 3)
                 - Hovov.swapaxes(1, 3)).copy()
            H += np.einsum("ab,ij->iajb", hbar.Hvv.cpu().numpy(), np.eye(no))
            H -= np.einsum("ij,ab->iajb", hbar.Hoo.cpu().numpy(), np.eye(nv))
            eps, c = np.linalg.eig(H.reshape(no * nv, no * nv))
            idx = eps.argsort()
            eps = eps[idx]
            c = c[:, idx]
        else:
            raise ValueError("%s is not a valid choice of initial guess "
                             "vectors." % method)
        guesses = np.reshape(np.real(c.T[:M, :]), (M, no, nv)).copy()
        return eps[:M], guesses

    def solve_eom(self, N=1, e_conv=1e-5, r_conv=1e-5, maxiter=100,
                  guess="HBAR_SS", maxM=None, chk=None, chk_every=1,
                  resume=False, device_subspace=None):
        """The N lowest EOM-CCSD roots by Davidson; returns (E, C): the
        roots (host array) and the final subspace (M, dim) on the device.

        guess: 'HBAR_SS', 'CIS', 'UNIT' or an (M0, dim) array of start
        vectors; the start block is orthonormalised by QR.  An array
        guess's doubles and every correction's are made pair-symmetric
        (`pair_symmetric`).  The Gram matrix C S^T grows by its new rows
        and columns only; converged roots are locked; each correction is
        Gram-Schmidt'ed twice (DGKS) against the subspace and the block,
        and dropped below 1e-4 of its norm; at maxM (default 10 N) the
        subspace collapses to the N Ritz vectors.  When the residuals stop
        improving at converged energies the solve stops at the working
        precision's floor (`self.residual_floor`); the best iterate is
        returned after 6 iterations without progress only when that
        plateau is within 30 sqrt(dim) eps, a floor the precision explains
        (pycc_tpu returns it at any plateau, which stops a root that a
        lower state is still replacing; the port iterates on).
        `self.converged`, `self.niter` and `self.ritz` (the N Ritz vectors
        of the final subspace, on the device) are set; the ccwfn's timers
        keep 'eom.guess' (host).

        chk=<path.npz> saves the subspace C (on the host; keys C, E,
        niter, pycc_tpu's format) at the start of every `chk_every`-th
        iteration; resume=True reloads it and rebuilds the sigma block
        with one sigma evaluation.  device_subspace is accepted as None or
        True only: the subspace always lives on the device here (pycc_tpu's
        host subspace, device_subspace=False, is not ported and raises
        ValueError)."""
        if device_subspace is False:
            raise ValueError("device_subspace=False: the host-resident "
                             "Davidson subspace is not ported; the "
                             "subspace always lives on the device")
        t_init = time.time()
        no, nv = self.no, self.nv
        D = self.D
        dt, dev = D.dtype, D.device
        s1_len = no * nv
        dim = s1_len + s1_len ** 2

        M = N * 2
        if maxM is None:
            maxM = N * 10
        niter0 = 0
        if resume and chk is not None and os.path.exists(chk):
            from .utils.checkpoint import load_amps
            d = load_amps(chk)
            C = torch.as_tensor(d["C"], device=dev).to(dt)
            niter0 = int(d["niter"])
            log.info("CCEOM resumed from %s at iteration %d (M=%d); "
                     "rebuilding sigma block" % (chk, niter0, C.shape[0]))
        elif not isinstance(guess, str):
            C = torch.as_tensor(np.asarray(guess), dtype=torch.float64,
                                device=dev)
            if C.dim() != 2 or C.shape[1] != dim:
                raise ValueError("array guess must be (M0, %d); got %r"
                                 % (dim, tuple(C.shape)))
            M = C.shape[0]
            self._in_subspace(C)
        else:
            with self.ccwfn.timers.time("eom.guess"):
                _, C1 = self.guess(M, guess)
            C = torch.zeros((M, dim), dtype=torch.float64, device=dev)
            C[:, :s1_len] = torch.from_numpy(C1.reshape(M, s1_len)).to(dev)
        if not niter0:
            # orthonormalise the start block; the subspace algebra then runs
            # in the sigma's own precision
            C = torch.linalg.qr(C.T)[0].T.contiguous().to(dt)
        S = self.sigma(C)
        G = (C @ S.T).double().cpu().numpy()
        E = np.zeros(N)

        converged = False
        self.residual_floor = None
        floor_est = np.sqrt(dim) * torch.finfo(dt).eps
        best_r = np.inf
        best_E = None
        best_dE = np.inf
        stalled = 0
        collapsed = False
        E_old = E
        for niter in range(niter0 + 1, maxiter + 1):
            E_old = E
            M = C.shape[0]
            self.niter = niter
            if chk is not None and (niter - 1) % chk_every == 0:
                from .utils.checkpoint import save_amps
                save_amps(chk, C=C, E=E, niter=niter - 1)
            w, a = np.linalg.eig(G)
            idx = np.real(w).argsort()[:N]
            E = np.real(w[idx])
            a = np.real(a[:, idx])
            aT = torch.as_tensor(a.T.copy(), dtype=dt, device=dev)
            Et = torch.as_tensor(E, dtype=dt, device=dev)

            r = aT @ S - Et[:, None] * (aT @ C)
            rnorms = torch.linalg.norm(r, dim=1).double().cpu().numpy()
            delta = r / (Et[:, None] - D[None, :])
            del r

            dE = E - E_old
            log.info("CCEOM iter %3d: M=%3d  E0=%.10f  |dE|=%.3e  "
                     "max|r|=%.3e  (%.1f s)"
                     % (niter, M, E[0], np.linalg.norm(dE), rnorms.max(),
                        time.time() - t_init))
            if (np.abs(np.linalg.norm(dE)) <= e_conv
                    and np.all(rnorms <= r_conv)):
                converged = True
                break

            # the Ritz pairs of a collapsed subspace are those it was
            # collapsed to: the iteration after a collapse brings no new
            # information, so its dE = 0 and unchanged residuals are no
            # stall and stop nothing
            fresh, collapsed = not collapsed, False
            if fresh and rnorms.max() < 0.98 * best_r:
                best_r = rnorms.max()
                best_E = E.copy()
                best_dE = float(np.linalg.norm(dE))
                stalled = 0
            elif fresh:
                stalled += 1
            if (fresh and stalled >= 3 and niter >= 6
                    and np.abs(np.linalg.norm(dE)) <= e_conv):
                converged = True
                self.residual_floor = float(rnorms.max())
                log.warning(
                    "CCEOM: residual norms stalled at %.2e (> r_conv=%.1e) "
                    "for 3 iterations with energies converged; stopping "
                    "at the precision noise floor." % (rnorms.max(), r_conv))
                break
            if (fresh and stalled >= 6 and niter >= 8
                    and best_r <= max(r_conv, 30.0 * floor_est)):
                # past the floor, noise-level corrections leak intruder
                # directions into the subspace: return the best iterate.
                # Only a plateau the working precision explains (sqrt(dim)
                # eps per unit vector) is a floor; above it a slow root
                # (or one that a lower state is replacing) keeps iterating
                self.residual_floor = float(best_r)
                E = best_E
                converged = best_dE <= max(e_conv, best_r)
                log.warning(
                    "CCEOM: residual norms stopped improving (floor %.2e "
                    "> r_conv=%.1e); returning the best iterate "
                    "(|dE| was %.2e there)." % (best_r, r_conv, best_dE))
                break

            if M >= maxM:
                # collapse to the current best N vectors
                C = torch.linalg.qr((aT @ C).T)[0].T.contiguous()
                S = self.sigma(C)
                G = (C @ S.T).double().cpu().numpy()
                collapsed = True
                continue

            added = []
            for k in range(N):
                if rnorms[k] <= r_conv:
                    continue
                d = self._in_subspace(delta[k:k + 1])[0]
                d0 = torch.linalg.norm(d)
                for _ in range(2):
                    d = d - (C @ d) @ C
                    for prev in added:
                        d = d - (d @ prev) * prev
                n = torch.linalg.norm(d)
                n_h, d0_h = torch.stack([n, d0]).tolist()
                if n_h > 1e-4 * d0_h:
                    added.append(d / n)
            if not added:
                # every correction was linearly dependent on the subspace;
                # trust it only if the residuals are actually small
                converged = bool(np.all(rnorms <= r_conv))
                if not converged:
                    warnings.warn(
                        "CCEOM: correction space exhausted with max residual "
                        "norm %.2e > r_conv=%.1e" % (rnorms.max(), r_conv))
                break
            new = torch.stack(added)
            del added, delta
            S_new = self.sigma(new)
            G_right = (C @ S_new.T).double().cpu().numpy()
            C = torch.cat([C, new])
            S = torch.cat([S, S_new])
            G = np.vstack((np.hstack((G, G_right)),
                           (new @ S.T).double().cpu().numpy()))

        self.converged = converged
        wR, aR = np.linalg.eig(G if C.shape[0] == G.shape[0]
                               else (C @ S.T).double().cpu().numpy())
        idxR = np.real(wR).argsort()[:N]
        aR = torch.as_tensor(np.real(aR[:, idxR]).T.copy(), dtype=dt,
                             device=dev)
        self.ritz = aR @ C
        if converged:
            log.info("\nCCEOM converged in %.3f seconds."
                     % (time.time() - t_init))
            log.info("\nState     E_h           eV")
            for state in range(N):
                log.info("  %3d  %12.10f  %12.10f"
                         % (state, E[state], E[state] * HARTREE2EV))
        else:
            warnings.warn("CCEOM did NOT converge in %d iterations "
                          "(|dE|=%.2e)" % (maxiter, np.linalg.norm(E - E_old)))
        return E, C

    def solve_eom_mixed(self, N=1, e_conv=1e-7, r_conv=1e-7, maxiter=100,
                        sp_conv=1e-5, sp_dtype=torch.float32,
                        refine_maxiter=None, guess="HBAR_SS", maxM=None,
                        **kw):
        """Mixed-precision EOM-CCSD, the scheme of ccwfn.solve_cc_mixed: the
        HBAR rebuilt in `sp_dtype` (float32) and a Davidson run to sp_conv
        or its noise floor, then the HBAR rebuilt in float64 and a Davidson
        seeded with the floor's N Ritz vectors (`self.ritz`).  t1/t2 are a
        parameter of the EOM equations: the exact float64 amplitudes are
        restored for the refinement.  `self.e_sp_floor` holds the floor's
        roots; self.hbar is left at the float64 build.  **kw (chk,
        device_subspace, ...) goes to both Davidsons.  Needs a
        precision='DP' ccwfn."""
        from .cchbar import cchbar
        cc = self.ccwfn
        if cc.precision != "DP":
            raise ValueError("solve_eom_mixed needs a precision='DP' ccwfn "
                             "construction (the f64 masters are the "
                             "refinement-stage Hamiltonian).")
        cc._ensure_mixed_masters()
        t1_64, t2_64 = cc.t1, cc.t2
        cc._cast_stage(sp_dtype)
        self.__init__(cchbar(cc))
        E_sp, _ = self.solve_eom(N, sp_conv, sp_conv, maxiter, guess=guess,
                                 maxM=maxM, **kw)
        self.e_sp_floor = np.array(E_sp)
        seeds = self.ritz.double().cpu().numpy()
        cc._cast_stage(torch.float64)
        cc.t1, cc.t2 = t1_64, t2_64
        self.__init__(cchbar(cc))
        return self.solve_eom(N, e_conv, r_conv, refine_maxiter or maxiter,
                              guess=seeds, maxM=maxM, **kw)
