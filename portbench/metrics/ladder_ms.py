"""ladder_ms.<cell suffix>: device milliseconds of a mesh's sharded CCSD
ladder a residual: the span 'mesh.ladder' around
`parallel.mesh.ladder_sharded` (tau copied to each card, one K1 launch a
shard of <ab|ef>, each shard's (a, b) columns copied home), timed on the
home card from the first shard's launch to the last column block copied
home, those under 'ccwfn.residual', over the count of 'ccwfn.residual'."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "mesh.ladder", "ccwfn.residual",
                        parent="ccwfn.residual")
