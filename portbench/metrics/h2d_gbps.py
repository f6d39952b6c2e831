"""h2d_gbps.<cell suffix>: the init's AO ERI host-to-device rate in GB/s,
the bytes of the span 'hamiltonian.h2d' (`build_hamiltonian`'s
`torch.as_tensor(ERI_ao, device=dev)`, counted by ERI_ao.nbytes) over
its device seconds, summed over the traced window's jobs."""

from portbench.harness import spans


def read(run):
    rows = spans.table(run)
    t = spans.device_s(rows, "hamiltonian.h2d")
    if not t:
        return None
    return rows["hamiltonian.h2d"]["bytes"] / t / 1e9
