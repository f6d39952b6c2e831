"""h2d_gbps.<cell suffix>: the init's AO ERI host-to-device rate in GB/s,
the bytes of the spans 'hamiltonian.h2d' over their device seconds,
summed over the traced window's jobs.  `hamiltonian.mo_eri_cells` sends
the AO ERI in chunks of its first index round the cards, each chunk
through the receiving card's `Uplink` in staged pieces of at most
STAGE_BYTES: one span a piece, on that card's copy stream, its bytes the
piece's, so the rate is a link's DMA rate, the host's staging into the
pinned buffers (span 'hamiltonian.stage') left out; on one card as on a
mesh.  A target without an Uplink (a CPU device) records one span a
chunk around the plain copy."""

from portbench.harness import spans


def read(run):
    rows = spans.table(run)
    t = spans.device_s(rows, "hamiltonian.h2d")
    if not t:
        return None
    return rows["hamiltonian.h2d"]["bytes"] / t / 1e9
