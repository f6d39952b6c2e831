"""gather_ms.<cell suffix>: device milliseconds of a mesh's gathers a CCSD
residual: every span 'mesh.gather' of the traced window (a slice of a
sharded ERI or L assembled on the home card by `Sharded.region`, or
`parallel.mesh.take`; its bytes are `Mesh.gathered_bytes`'s increment),
timed on the home card, over the count of 'ccwfn.residual'.

Bytes, by the count of models/ccsd.py: a full-storage CCSD residual reads
ERI[o,v,v,v] four times, ERI[v,v,v,o] and L[o,v,v,v] once each (o v^3,
1.93 GB each at (o, v) = (24, 216)), thirteen o^2 v^2 blocks (0.215 GB
each), seven o^3 v and one o^4: 8 (6 o v^3 + 13 o^2 v^2 + 7 o^3 v + o^4)
bytes, 14.57 GB; the energy adds L[o,o,v,v] an iteration and the init
ERI[o,o,v,v] once a job."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "mesh.gather", "ccwfn.residual")
