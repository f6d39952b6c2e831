"""A single-process device mesh for the v^4 storage and its ladders.

The counterpart of pycc_tpu/parallel/mesh.py.  pycc_tpu lays its tensors
over a jax Mesh with the axes ('va', 'vb') and lets GSPMD partition every
jitted step.  The port keeps pycc_tpu's single controller -- one Python
process drives every device of the mesh -- and partitions what holds the
v^4 work:

* the storage.  Every v^4 and o v^3 operand (the full ERI and L, the vvvv
  and ovvv blocks, the DF factor Bvv, HBAR's Hvvvv, Hvovv and Hvvvo and
  the DF-HBAR's dressed Bd_ae) is a `Sharded`: one contiguous piece a grid
  cell, on that cell's device;
* the ladders.  Each particle-particle ladder is one K1 launch a shard on
  the shard's device (`ladder_sharded`; over DF factors one launch an
  a-block a shard, models/dfhbar.ladder_apply), and each shard's output
  columns are copied into the result on the home device.  No ladder sums
  across shards, so a sharded ladder gives the unsharded one's numbers.

Everything else stays on the home device, the mesh's first: the
amplitudes t, l, X and Y, the denominators, the EOM subspace and every
block of o^2 v^2 and smaller.  Those carry o^2 v^2 work at most, and
splitting them would add a copy an operation while saving memory that
does not matter beside v^4.  A reader of a sharded operand other than a
ladder (a residual term reading ERI[o,v,v,v], the EOM sigma reading
Hvovv) slices it, and gets the part it asks for assembled on the home
device (`Sharded.__getitem__`), so the equations run verbatim.  No other
use of the whole operand is allowed: a torch function, an operator or a
tensor method on a Sharded raises, and a reader that does want the whole
asks for it (`full`).  `Mesh.gathered_bytes` counts the bytes such reads
copy out of the shards.

The sharded operands are cut from where they were made, piece by piece:
ccwfn builds the four-index integrals of a mesh solver in host memory
(and solve_cc_mixed casts its host masters a piece at a time), so the
home device holds its own pieces and no whole v^4 tensor.  The formulas
that run on the pieces (HBAR's Hvvvv, the DF dressings, the ladder) are
the unsharded code's: `per_piece` and `map_leading` apply them once to a
plain tensor, with slices that cover it.

No process group is made (no NCCL, no DTensor): NCCL refuses two ranks
on one GPU, so a one-card machine could check nothing past a world size
of 1; the CPU tests would have to spawn processes; and K1 and K2 are
ctypes launches with no DTensor sharding rule.

Layouts (a spec over the tensor's axes; pycc_tpu's PartitionSpec beside):

  full ERI, L        (None, None, va, vb)   as pycc_tpu
  H.vvvv, K1's W     (va, vb, None, None)   pycc_tpu reads the ladder from
                                            ERI; the port's contiguous copy
                                            keeps the output columns (a, b)
                                            leading, so a shard is one K1 B
                                            operand (cut from the ERI)
  blocks.vvvv        (va, vb, None, None)   as pycc_tpu
  blocks.ovvv        (None, None, va, vb)   as pycc_tpu
  blocks oovv, ovov  home                   pycc_tpu: over two v axes
  DF Bvv             (None, va, vb)         as pycc_tpu
  DF Bov             home                   pycc_tpu: over vb
  HBAR Hvvvv         (va, vb, None, None)   pycc_tpu: the trailing two;
                                            built shard by shard
                                            (cchbar.build_hbar)
  HBAR Hvvvv_efab    (va, vb, None, None)   of its (a, b, e, f) layout
  HBAR Hvovv         (None, None, va, vb)   as pycc_tpu
  HBAR Hvvvo         (va, vb, None, None)   pycc_tpu: the trailing two,
                                            whose last is occupied
  other HBAR blocks  home                   pycc_tpu: the trailing two
  DF-HBAR Bd_ae      (None, va, vb)         as pycc_tpu
  DF-HBAR Hovvo ...  home                   pycc_tpu: one v axis
  t1, t2, l, X, Y    home                   pycc_tpu: t2 over (va, vb)

An axis that does not divide its dimension is split into near-equal
contiguous ranges (torch.tensor_split's); pycc_tpu's `_put` drops such an
axis, since jax refuses uneven shards.
"""

import torch

AXES = ("va", "vb")


def split_ranges(n, k):
    """k near-equal contiguous ranges covering [0, n): the first n % k one
    longer (torch.tensor_split's split)."""
    q, r = divmod(n, k)
    cuts = [0]
    for i in range(k):
        cuts.append(cuts[-1] + q + (i < r))
    return [(cuts[i], cuts[i + 1]) for i in range(k)]


class Mesh:
    """A 2-D grid of torch devices with the axes ('va', 'vb'), driven by
    one process.  `home` (the first device) holds everything that is not
    sharded.  A device may appear in several cells; `distinct` lists each
    once."""

    def __init__(self, devices, shape):
        devices = [torch.device(d) for d in devices]
        shape = tuple(int(x) for x in shape)
        if len(shape) != 2 or shape[0] * shape[1] != len(devices):
            raise ValueError("a mesh of shape %s needs %d devices, got %d"
                             % (shape, shape[0] * shape[1] if len(shape) == 2
                                else 0, len(devices)))
        self.shape = shape
        self.devices = [devices[i * shape[1]:(i + 1) * shape[1]]
                        for i in range(shape[0])]
        self.gathered_bytes = 0

    @property
    def size(self):
        return self.shape[0] * self.shape[1]

    @property
    def home(self):
        return self.devices[0][0]

    @property
    def distinct(self):
        seen = []
        for _, _, d in self.cells():
            if d not in seen:
                seen.append(d)
        return seen

    def cells(self):
        """(i, j, device) for every cell, row by row."""
        for i, row in enumerate(self.devices):
            for j, dev in enumerate(row):
                yield i, j, dev

    def __repr__(self):
        return "Mesh(shape=%s, devices=%s)" % (
            self.shape, [str(d) for row in self.devices for d in row])


def make_mesh(n_devices=None, devices=None, shape=None):
    """A 2-D ('va', 'vb') mesh over `devices`, or over the first
    `n_devices` visible CUDA devices (all of them when None), in the most
    square shape unless `shape` is given, as pycc_tpu.parallel.make_mesh
    factorises it.  Only a `devices` list may repeat a device (["cpu"] * 8
    for the CPU tests, ["cuda:0"] * 4 for a one-card run): n_devices past
    the visible count raises, and no mesh shrinks by itself."""
    if devices is None:
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        n = len(avail) if n_devices is None else int(n_devices)
        if n < 1 or n > len(avail):
            raise ValueError("make_mesh(n_devices=%s): %d CUDA device(s) are "
                             "visible; pass devices= to build a mesh that "
                             "repeats a device" % (n_devices, len(avail)))
        devices = avail[:n]
    devices = list(devices)
    n = len(devices)
    if n_devices is not None and int(n_devices) != n:
        raise ValueError("make_mesh: n_devices=%s but %d devices were given"
                         % (n_devices, n))
    if n < 1:
        raise ValueError("make_mesh needs at least one device")
    if shape is None:
        a = int(n ** 0.5)
        while n % a:
            a -= 1
        shape = (a, n // a)
    return Mesh(devices, shape)


def _copy_to(x, device, dtype=None):
    """A contiguous copy of x on `device` (cast to `dtype`, the stage's
    dtype of a real x or its complex width, `_cast`) that shares no
    storage with x."""
    out = torch.empty(x.shape, dtype=_cast(x, dtype), device=device)
    out.copy_(x)
    return out


def _cast(x, dtype):
    """x's dtype at a stage of `dtype` (None: its own): a complex x takes
    the complex type of dtype's width."""
    if dtype is None:
        return x.dtype
    if x.is_complex():
        return torch.complex64 if dtype == torch.float32 else torch.complex128
    return dtype


def _norm(key, shape):
    """A tuple of slices with step 1 as (start, stop) pairs, one a dim."""
    if not isinstance(key, tuple):
        key = (key,)
    if len(key) > len(shape):
        raise IndexError("too many indices for a tensor of %d dims"
                         % len(shape))
    out = []
    for d, n in enumerate(shape):
        s = key[d] if d < len(key) else slice(None)
        if not isinstance(s, slice):
            raise TypeError("a Sharded tensor takes slices only, got %r"
                            % (s,))
        lo, hi, step = s.indices(n)
        if step != 1:
            raise ValueError("a Sharded tensor takes slices of step 1")
        out.append((lo, max(lo, hi)))
    return tuple(out)


class Sharded:
    """A tensor laid over a `Mesh`: `spec` names the mesh axis ('va',
    'vb' or None) each dimension is split over, and every cell holds the
    piece its ranges cut on its device (contiguous as `put` and `build`
    make it; `transpose` gives views).  Cells that cut the same ranges on
    one device share one piece.

    The ladders read the pieces (`shards`).  Any other reader gets a plain
    tensor assembled on the home device: indexing with slices assembles
    that part, `full` the whole.  `to(dtype)` casts shard by shard and
    stays sharded.  Nothing else reads it: it is no tensor, so a torch
    function or an operator given one raises."""

    def __init__(self, mesh, spec, shape, pieces):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = torch.Size(shape)
        self.pieces = pieces
        self.dtype = next(iter(pieces.values())).dtype

    @classmethod
    def build(cls, mesh, spec, shape, make):
        """Each cell's piece is `make(slices, device)`, the piece of the
        cell's ranges on its device (made once for cells that share
        them)."""
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        for p in spec:
            if p not in (None,) + AXES:
                raise ValueError("unknown mesh axis %r" % (p,))
        pieces, made = {}, {}
        for i, j, dev in mesh.cells():
            sl = _cell_slices(mesh, spec, shape, i, j)
            key = (tuple((s.start, s.stop) for s in sl), dev)
            if key not in made:
                made[key] = make(sl, dev)
            pieces[(i, j)] = made[key]
        return cls(mesh, spec, shape, pieces)

    @classmethod
    def put(cls, x, mesh, spec, dtype=None):
        """x (a tensor on any device, host memory included) laid over the
        mesh: each piece a copy of x's part on its cell's device, cast to
        `dtype` as it is copied (`_cast`)."""
        return cls.build(mesh, spec, x.shape,
                         lambda sl, dev: _copy_to(x[sl], dev, dtype))

    def cell_slices(self, i, j):
        return _cell_slices(self.mesh, self.spec, self.shape, i, j)

    def shards(self):
        """(slices, piece) for every distinct piece (each once)."""
        seen = set()
        for i, j, _ in self.mesh.cells():
            p = self.pieces[(i, j)]
            if id(p) not in seen:
                seen.add(id(p))
                yield self.cell_slices(i, j), p

    def map(self, fn):
        """A Sharded of the same layout whose pieces are fn(piece, slices),
        each on the piece's device."""
        return self._remap(fn, self.spec, self.shape)

    def _remap(self, fn, spec, shape):
        done = {}
        pieces = {}
        for i, j, _ in self.mesh.cells():
            p = self.pieces[(i, j)]
            if id(p) not in done:
                done[id(p)] = fn(p, self.cell_slices(i, j))
            pieces[(i, j)] = done[id(p)]
        return Sharded(self.mesh, spec, shape, pieces)

    def transpose(self, d0, d1):
        """The transpose, still Sharded: each piece's view, the spec's
        axes swapped with the dimensions."""
        perm = list(range(self.ndim))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return self._remap(lambda p, sl: p.transpose(d0, d1),
                           [self.spec[k] for k in perm],
                           [self.shape[k] for k in perm])

    def region(self, key, device=None):
        """The part `key` (slices) cut as one tensor on `device` (the home
        device by default), assembled from the pieces it meets."""
        device = self.mesh.home if device is None else torch.device(device)
        want = _norm(key, self.shape)
        out = torch.empty([hi - lo for lo, hi in want], dtype=self.dtype,
                          device=device)
        sources = {}
        for sl, p in self.shards():
            k = tuple((s.start, s.stop) for s in sl)
            if k not in sources or p.device == device:
                sources[k] = p
        for k, p in sources.items():
            inter = [(max(a, c), min(b, d)) for (a, b), (c, d)
                     in zip(k, want)]
            if any(lo >= hi for lo, hi in inter):
                continue
            src = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                        in zip(inter, k))
            dst = tuple(slice(lo - c, hi - c) for (lo, hi), (c, _)
                        in zip(inter, want))
            out[dst].copy_(p[src])
        self.mesh.gathered_bytes += out.numel() * out.element_size()
        return out

    def full(self, device=None):
        """The whole tensor on `device` (the home device by default)."""
        return self.region((), device)

    def __getitem__(self, key):
        return self.region(key)

    def to(self, dtype):
        """Cast piece by piece; stays Sharded.  (A whole copy on a device
        is `full(device)`.)"""
        if not isinstance(dtype, torch.dtype):
            raise TypeError("Sharded.to takes a dtype; full(device) "
                            "assembles the tensor on a device")
        return self.map(lambda p, sl: p.to(dtype))

    @property
    def ndim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def element_size(self):
        return next(iter(self.pieces.values())).element_size()

    def is_complex(self):
        return self.dtype.is_complex

    def cell_bytes(self):
        """{(i, j): bytes of the cell's piece}."""
        return {c: p.numel() * p.element_size()
                for c, p in self.pieces.items()}

    def __repr__(self):
        return "Sharded(shape=%s, dtype=%s, spec=%s, mesh=%s)" % (
            tuple(self.shape), self.dtype, self.spec, self.mesh.shape)


def _cell_slices(mesh, spec, shape, i, j):
    idx = {"va": i, "vb": j}
    out = []
    for d, p in enumerate(spec):
        if p is None:
            out.append(slice(0, shape[d]))
        else:
            lo, hi = split_ranges(shape[d], mesh.shape[AXES.index(p)])[idx[p]]
            out.append(slice(lo, hi))
    return tuple(out)


def _whole(shape):
    return tuple(slice(0, n) for n in shape)


def region(x, key, device=None):
    """x[key] (slices) on `device` (None: where x lives, the home device
    for a Sharded x): assembled from the pieces it meets when x is
    Sharded, else a view, copied only to reach another device."""
    if isinstance(x, Sharded):
        return x.region(key, device)
    return x[key] if device is None else x[key].to(device)


def per_piece(x, fn):
    """fn(piece, slices) over x's layout: a Sharded of x's layout whose
    pieces fn makes, each on its piece's device, or for a plain x one
    call fn(x, slices that cover x)."""
    if isinstance(x, Sharded):
        return x.map(fn)
    return fn(x, _whole(x.shape))


def build_like(x, spec, shape, make):
    """A tensor of `shape` made by make(slices, device): a Sharded over x's
    mesh on `spec` when x is Sharded, else one call that makes it whole on
    x's device."""
    if isinstance(x, Sharded):
        return Sharded.build(x.mesh, spec, shape, make)
    return make(_whole(shape), x.device)


def contract_pieces(subscripts, *operands, keep=False):
    """contract(subscripts, *operands) over the pieces of its Sharded
    operands, once a cell: the formula of a plain einsum, applied piece by
    piece.  Without a Sharded operand it is `contract` itself.

    The cell's letters are the subscript letters of the Sharded operands'
    sharded axes; every Sharded operand must name the same letters on the
    same mesh axes.  A cell cuts each Sharded operand's other axes that
    carry a cell letter, and each whole operand's axes that do, to the
    cell's ranges (a whole operand is copied to the cell's device), and
    contracts there.  The cells' results meet on the home device: a
    cell's result is added into its block of the output, the block its
    surviving letters cut, so where both letters survive each cell writes
    its own block and where a letter is contracted away the cells that
    differ in it are summed.  keep=True leaves each cell's result on its
    device instead, as a Sharded of the same layout: the output must then
    begin with the cell letters in mesh-axis order.  Cells that cut the
    same ranges (a 'va'-only layout on several devices) contract once."""
    from ..ops.contract import contract
    sharded = [k for k, x in enumerate(operands) if isinstance(x, Sharded)]
    if not sharded:
        return contract(subscripts, *operands)
    ins, out = subscripts.replace(" ", "").split("->")
    terms = ins.split(",")
    first = operands[sharded[0]]
    letters = _cell_letters(terms[sharded[0]], first.spec)
    for k in sharded[1:]:
        if (operands[k].mesh is not first.mesh
                or _cell_letters(terms[k], operands[k].spec) != letters):
            raise ValueError("contract_pieces(%r): the Sharded operands cut "
                             "different letters or meshes" % subscripts)
    mesh = first.mesh
    sizes = {}
    for t, x in zip(terms, operands):
        for c, n in zip(t, x.shape):
            sizes.setdefault(c, n)
    done = {}
    for i, j, dev in mesh.cells():
        cut = first.cell_slices(i, j)
        rng = {letters[ax]: cut[d] for d, ax in enumerate(first.spec)
               if ax is not None}
        key = tuple((s.start, s.stop) for s in rng.values())
        if key in done:
            continue
        ops = []
        for t, x in zip(terms, operands):
            if isinstance(x, Sharded):
                idx = tuple(slice(None) if x.spec[d] is not None
                            else rng.get(c, slice(None))
                            for d, c in enumerate(t))
                ops.append(x.pieces[(i, j)][idx])
            else:
                idx = tuple(rng.get(c, slice(None)) for c in t)
                ops.append(x[idx].to(dev))
        done[key] = (rng, contract(subscripts, *ops))
    if keep:
        axes = [ax for ax in AXES if ax in letters]
        if out[:len(axes)] != "".join(letters[ax] for ax in axes):
            raise ValueError("contract_pieces(%r, keep=True): the output "
                             "must begin with the cell letters" % subscripts)
        spec = tuple(axes) + (None,) * (len(out) - len(axes))
        pieces = {}
        for i, j, _ in mesh.cells():
            cut = first.cell_slices(i, j)
            key = tuple((s.start, s.stop) for d, s in enumerate(cut)
                        if first.spec[d] is not None)
            pieces[(i, j)] = done[key][1]
        return Sharded(mesh, spec, [sizes[c] for c in out], pieces)
    cells = list(done.values())
    res = torch.zeros([sizes[c] for c in out], dtype=cells[0][1].dtype,
                      device=mesh.home)
    for rng, r in cells:
        res[tuple(rng.get(c, slice(None)) for c in out)] += r.to(mesh.home)
    return res


def _cell_letters(term, spec):
    """{mesh axis: the letter of `term` on the axis it cuts}."""
    return {ax: term[d] for d, ax in enumerate(spec) if ax is not None}


def take(x, *index):
    """x[index] for index tensors (or ints) on x's leading axes, broadcast
    together, on the home device: for a Sharded x cut over its leading
    axis alone, each piece gives the entries whose leading index falls in
    its range (a gather on the piece's device, copied home); a plain x is
    indexed as it is."""
    if not isinstance(x, Sharded):
        return x[index]
    if any(p is not None for p in x.spec[1:]):
        raise ValueError("take: x must be cut over its leading axis alone")
    home = x.mesh.home
    idx = torch.broadcast_tensors(*(torch.as_tensor(k, device=home)
                                    for k in index))
    out = torch.empty(tuple(idx[0].shape) + tuple(x.shape[len(idx):]),
                      dtype=x.dtype, device=home)
    seen = set()
    for sl, p in x.shards():
        lo, hi = sl[0].start, sl[0].stop
        if (lo, hi) in seen:
            continue
        seen.add((lo, hi))
        sel = (idx[0] >= lo) & (idx[0] < hi)
        got = [k[sel].to(p.device) for k in idx]
        got[0] = got[0] - lo
        out[sel] = p[tuple(got)].to(home)
    x.mesh.gathered_bytes += out.numel() * out.element_size()
    return out


def shard_pair_stacks(pre, mesh, no):
    """The local solver's precomputed stacks over the mesh, by pycc_tpu's
    rule (parallel/mesh.py shard_pair_stacks): a floating stack whose two
    leading dims are (no, no) and which carries a local-virtual payload
    (a later dim that is not no) is cut over ('va', 'vb') on those two
    dims; a compact screened stack, whose leading dim is the strong-pair
    count P > no, over 'va'; everything else stays whole on the home
    device, the all-occupied F_oo and ERI_oooo included.  Integer and
    boolean tensors (the pair index maps and their masks) stay whole on
    the home device too, where pycc_tpu cuts those of leading dim P over
    'va': every gather reads them whole.  Entries that are not tensors
    pass through, and a stack held under two keys is cut once."""
    out, cut = {}, {}
    for k, x in pre.items():
        if not isinstance(x, torch.Tensor):
            out[k] = x
            continue
        if id(x) in cut:
            out[k] = cut[id(x)]
            continue
        spec = None
        if x.is_floating_point() or x.is_complex():
            if (x.ndim >= 3 and x.shape[0] == no and x.shape[1] == no
                    and any(d != no for d in x.shape[2:])):
                spec = ("va", "vb")
            elif x.ndim >= 1 and x.shape[0] > no:
                spec = ("va",)
        y = _home(x, mesh) if spec is None else Sharded.put(x, mesh, spec)
        cut[id(x)] = out[k] = y
    return out


def mesh_vvvv(cc):
    """A mesh ccwfn's ladder operand (<ab|ef> Sharded over (a, b)), for
    the HBAR builds; None without a mesh."""
    return None if getattr(cc, "mesh", None) is None else cc.vvvv()


def dense(x, device=None):
    """x whole on `device` (None: where it lives, the home device for a
    Sharded x): assembled from the pieces when Sharded, else x itself,
    moved when asked."""
    if isinstance(x, Sharded):
        return x.full(device)
    return x if device is None else x.to(device)


def device_bytes(*objs):
    """{device: bytes} that the tensors in objs (tensors, Sharded, tuples,
    NamedTuples, or dataclasses such as Hamiltonian and HBar, whose cached
    attributes count too) hold on each device, each storage counted
    once."""
    import dataclasses
    out, seen, walked = {}, set(), set()

    def add(t):
        key = (t.untyped_storage().data_ptr(), t.device)
        if key in seen:
            return
        seen.add(key)
        out[str(t.device)] = (out.get(str(t.device), 0)
                              + t.untyped_storage().nbytes())

    def walk(x):
        if isinstance(x, Sharded):
            for _, p in x.shards():
                add(p)
        elif isinstance(x, torch.Tensor):
            add(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif dataclasses.is_dataclass(x) and id(x) not in walked:
            walked.add(id(x))
            for y in vars(x).values():
                walk(y)

    for x in objs:
        walk(x)
    return out


# ---------------------------------------------------------------------------
# the storage layouts (pycc_tpu's shard_* functions)
# ---------------------------------------------------------------------------

def _home(x, mesh, dtype=None):
    return None if x is None else x.to(mesh.home, _cast(x, dtype))


def shard_hamiltonian(H, mesh, dtype=None):
    """Full storage over the mesh: ERI and L over their last two axes, and
    the ladder's operand H.vvvv (K1's W, <ab|ef>) over its output columns
    (a, b), cut from ERI shard by shard; F and the properties on the home
    device.  H may lie in host memory: every piece is cut from it and cast
    to `dtype` (None: as it is) on its way to its device.  An H without
    ERI (blocked or DF storage) only moves to the home device."""
    from ..hamiltonian import Hamiltonian
    tup = lambda ms: tuple(_home(m, mesh, dtype) for m in ms)
    props = dict(F=_home(H.F, mesh, dtype), mu=tup(H.mu), m=tup(H.m),
                 p=tup(H.p), Q=tup(H.Q), no=H.no)
    if H.ERI is None:
        return Hamiltonian(ERI=None, L=None, **props)
    spec4 = (None, None, "va", "vb")
    no, nv = H.no, H.ERI.shape[0] - H.no
    v = slice(no, None)
    ERIvvvv = H.ERI[v, v, v, v]
    W = Sharded.build(mesh, ("va", "vb"), (nv,) * 4,
                      lambda sl, dev: _copy_to(ERIvvvv[sl], dev, dtype))
    out = Hamiltonian(ERI=Sharded.put(H.ERI, mesh, spec4, dtype),
                      L=Sharded.put(H.L, mesh, spec4, dtype), **props)
    # Hamiltonian.vvvv is a cached property: seed its cache with the
    # sharded ladder operand
    out.__dict__["vvvv"] = W
    return out


def shard_blocks(blocks, mesh, dtype=None):
    """ERIBlocks over the mesh: vvvv over its leading two axes (K1's B
    operand a shard), ovvv over its trailing two; the o-heavy blocks, oovv
    and ovov on the home device.  Cut and cast as shard_hamiltonian's."""
    from ..models.blocked import ERIBlocks
    home = lambda x: _home(x, mesh, dtype)
    return ERIBlocks(
        oooo=home(blocks.oooo), ooov=home(blocks.ooov),
        oovv=home(blocks.oovv), ovov=home(blocks.ovov),
        ovvv=Sharded.put(blocks.ovvv, mesh, (None, None, "va", "vb"), dtype),
        vvvv=Sharded.put(blocks.vvvv, mesh, ("va", "vb"), dtype))


def shard_df(dfb, mesh, dtype=None):
    """DF factors over the mesh: Bvv (naux v^2) over its two virtual axes;
    Boo and Bov on the home device.  Cut and cast as shard_hamiltonian's."""
    from ..models.dfccsd import DFERI
    return DFERI(Boo=_home(dfb.Boo, mesh, dtype),
                 Bov=_home(dfb.Bov, mesh, dtype),
                 Bvv=_shard(dfb.Bvv, mesh, (None, "va", "vb"), dtype))


def _shard(x, mesh, spec, dtype=None):
    if isinstance(x, Sharded):
        return x if dtype is None else x.to(dtype)
    return Sharded.put(x, mesh, spec, dtype)


def shard_hbar(hbar, mesh):
    """A built HBAR over the mesh.  Dense (cchbar.HBar): Hvvvv over (a, b)
    (already so when cchbar built it shard by shard), Hvovv over its
    trailing two axes, Hvvvo over its leading two, the rest on the home
    device.  DF (dfhbar.DFHBar): the factors on the DF layout, Bd_ae like
    Bvv, the explicit blocks (at most o^3 v) on the home device."""
    import dataclasses

    from ..models.dfhbar import DFHBar
    if isinstance(hbar, DFHBar):
        return hbar._replace(df=shard_df(hbar.df, mesh),
                             Bd_ae=_shard(hbar.Bd_ae, mesh,
                                          (None, "va", "vb")))
    return dataclasses.replace(
        hbar, Hvvvv=_shard(hbar.Hvvvv, mesh, ("va", "vb")),
        Hvovv=_shard(hbar.Hvovv, mesh, (None, None, "va", "vb")),
        Hvvvo=_shard(hbar.Hvvvo, mesh, ("va", "vb")), _efab=None)


# ---------------------------------------------------------------------------
# the ladders, shard by shard
# ---------------------------------------------------------------------------

def ladder_sharded(tau, W, fn):
    """'ijef,abef->ijab' for W Sharded over (a, b), or a StackedComplex
    whose ri is: fn(tau, W_s) (models/ccsd.vvvv_contract on a plain
    piece: one K1 launch) a shard, on the shard's device with tau copied
    there once a device, each shard's (a, b) columns copied into the
    result on tau's device.  Every shard is launched before any result is
    copied back, so shards on different cards run at once."""
    from ..ops.kernels.vvvv import StackedComplex
    stacked = isinstance(W, StackedComplex)
    Wsh = W.ri if stacked else W
    on = {}
    done = []
    for sl, piece in Wsh.shards():
        sa, sb = sl[-4], sl[-3]
        if sa.stop == sa.start or sb.stop == sb.start:
            continue
        dev = piece.device
        if dev not in on:
            on[dev] = tau.to(dev)
        done.append((sa, sb, fn(on[dev], StackedComplex(piece) if stacked
                                else piece)))
    out = torch.empty(tuple(tau.shape[:2]) + tuple(W.shape[:2]),
                      dtype=done[0][2].dtype, device=tau.device)
    for sa, sb, C in done:
        out[:, :, sa, sb].copy_(C)
    return out


def is_sharded(W):
    """W is Sharded, or a StackedComplex whose ri is."""
    return isinstance(getattr(W, "ri", W), Sharded)


def map_leading(W, fn, tail):
    """out[a, b, ...] = fn(piece, slices)[a - a0, b - b0, ...] for W
    Sharded over its leading (a, b): fn runs on each shard's device, and
    its (nA, nB, *tail) result is copied into `out` on the home device.
    A plain W is one call fn(W, slices that cover it)."""
    if not isinstance(W, Sharded):
        return fn(W, _whole(W.shape))
    out = None
    for sl, piece in W.shards():
        r = fn(piece, sl)
        if out is None:
            out = torch.empty(tuple(W.shape[:2]) + tuple(tail),
                              dtype=r.dtype, device=W.mesh.home)
        out[sl[0], sl[1]].copy_(r)
    return out
