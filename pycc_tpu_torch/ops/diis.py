"""DIIS (Pulay) extrapolation over tuples of amplitude tensors.

The counterpart of pycc_tpu/ops/diis.py: fixed-size ring buffers of
amplitude and error snapshots live on the amplitudes' device, and the
bordered B-matrix system is solved there too.  Unlike the JAX version the
ring is updated in place (`push`), so only one copy of it ever exists.
"""

from dataclasses import dataclass

import torch


def _flatten(amps):
    return torch.cat([x.reshape(-1) for x in amps])


def _unflatten(vec, template):
    out = []
    pos = 0
    for leaf in template:
        n = leaf.numel()
        out.append(vec[pos:pos + n].reshape(leaf.shape))
        pos += n
    return tuple(out)


@dataclass
class DIISState:
    amps: torch.Tensor   # (max_diis, N) ring of amplitude snapshots
    errs: torch.Tensor   # (max_diis, N) ring of error vectors
    count: int = 0       # number of vectors pushed so far


class DIIS:
    """DIIS over a tuple of amplitude tensors with a fixed ring size."""

    def __init__(self, template, max_diis=8):
        self.max_diis = max_diis
        self.template = tuple(template)
        self.n = sum(x.numel() for x in self.template)
        self.dtype = self.template[0].dtype
        self.device = self.template[0].device

    def init(self):
        z = torch.zeros((self.max_diis, self.n), dtype=self.dtype,
                        device=self.device)
        return DIISState(amps=z, errs=torch.zeros_like(z))

    def push(self, state, amps, prev_amps):
        """Record a new (amplitude, error) pair in place; error = amps - prev."""
        a = _flatten(amps)
        slot = state.count % self.max_diis
        state.amps[slot] = a
        torch.sub(a, _flatten(prev_amps), out=state.errs[slot])
        state.count += 1
        return state

    def mark(self, state):
        """What the next `push` overwrites: its slot's amplitude and error
        rows (two copies of one row each, never the ring) and the count;
        `restore` puts them back."""
        slot = state.count % self.max_diis
        return (slot, state.amps[slot].clone(), state.errs[slot].clone(),
                state.count)

    def restore(self, state, mark):
        """Undo the push that followed `mark(state)`, in place."""
        slot, amps, errs, count = mark
        state.amps[slot] = amps
        state.errs[slot] = errs
        state.count = count

    def extrapolate(self, state, amps):
        """Solve the Pulay system over the filled slots.  Unfilled slots are
        masked to an identity row and a zero border, and B is normalised by
        its largest valid element, exactly as in pycc_tpu."""
        m = self.max_diis
        nvec = min(state.count, m)
        if nvec < 2:
            return tuple(amps)
        dev = state.errs.device
        valid = torch.arange(m, device=dev) < nvec
        E = state.errs
        B = (E.conj() @ E.T).real
        mask2 = valid[:, None] & valid[None, :]
        bmax = torch.where(mask2, B.abs(), 0.0).max()
        B = B / torch.where(bmax > 0, bmax, 1.0)
        eye = torch.eye(m, dtype=B.dtype, device=dev)
        B = torch.where(mask2, B, eye)
        border = torch.where(valid, -1.0, 0.0).to(B.dtype)
        Bb = torch.zeros((m + 1, m + 1), dtype=B.dtype, device=dev)
        Bb[:m, :m] = B
        Bb[:m, m] = border
        Bb[m, :m] = border
        rhs = torch.zeros((m + 1,), dtype=B.dtype, device=dev)
        rhs[m] = -1.0
        # a singular Pulay matrix (error vectors exactly dependent, as a
        # solve at its floor on the card can give) takes the newest
        # amplitudes unextrapolated; torch.linalg.solve would raise there
        # and jnp.linalg.solve returns non-finite coefficients.  No host
        # read: the choice is made on the device
        c, info = torch.linalg.solve_ex(Bb, rhs)
        c = torch.where(valid, c[:m], 0.0)
        newest = torch.arange(m, device=dev) == (state.count - 1) % m
        ok = (info == 0) & torch.isfinite(c).all()
        c = torch.where(ok, c, newest.to(c.dtype))
        new = c.to(state.amps.dtype) @ state.amps
        return _unflatten(new, self.template)
