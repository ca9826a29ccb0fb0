"""Distributed execution over torch.distributed: slab and pencil FFTs,
block layouts, halo exchange and reductions (the port of
marlin_tpu/parallel.py).

One process a device; each rank holds its own block of every field, and
the Domain (``domain.py``) builds its axes and k-tables for that block.
The process group is NCCL where the domain's device is CUDA and gloo on
the CPU; the port never forms one on its own (``main.py`` joins the
default group when ``torchrun`` launches the CLI, and a caller hands a
``Mesh`` to ``run_deck``).

- FFT_SLAB: real space is X-Z slabs stacked along Y, reciprocal space Y-Z
  slabs along X (the reference's convention).  A forward transform is the
  local transforms over the unsharded axes, one ``all_to_all_single`` of
  contiguous tiles, and the transform along the axis that was sharded
  (``fft_slab``).  3-D grids rfft the z axis (local in both layouts, so the
  half extent is never split); 2-D grids keep the full complex spectrum.
  A grid that the mesh does not divide takes the gather path
  (``_gather_fft``): the field is gathered, transformed whole and the
  rank keeps its slice.  Under ``fft_backend = PALLAS`` the same slab runs
  on the unordered-FFT kernels (``fft_slab_pallas``): kernels 1 and 3 on
  the Y-sharded block, one planar transpose, kernel 3 (inverse: 4) on the
  X-sharded block.
- FFT_PENCIL: a (p1, p2) mesh over 3-D grids; real space is X pencils
  (y cut by p1, z by p2), reciprocal space Z pencils (x cut by p1, y by
  p2).  A forward transform is a local rfft along x, its half extent
  zero-padded to a multiple of p1 (``Domain.reciprocal_pad``), one
  ``all_to_all`` within each mesh column (over p1), the y transform, one
  within each mesh row (over p2) and the z transform (``fft_pencil``).
  ``make_mesh`` forms the row and column groups once.
- REAL_SPACE: block decomposition over a 1-D (x), 2-D (x, y) or 3-D
  (x, y, z) mesh.  What GSPMD inserts for the JAX package is explicit
  here: ``halo_ring`` brings a block's neighbouring planes (on a 2-D mesh
  the y rows and their x corners too) by ``batch_isend_irecv``, for the
  fused LBM kernel; the eager computes pad their block with its
  neighbours' planes, one exchange a cut axis (``halo_pad``: corners and
  edges ride the later axes' exchanges) and slice their periodic roll
  across ranks out of that (``shifted``).  A neighbour that is this rank
  itself is a local slice.
- Reductions (sum, max, min, and a max that keeps NaN) are ``all_reduce``
  over the mesh's group.
- Whole arrays for the host: ``gather_to`` puts every rank's block
  together on one rank (the sharded checkpoint, the Exodus and aux
  samples), ``block_of`` cuts a rank's block out of a global array (the
  checkpoint's resume).  A state leaf's layout (``REAL``, ``RECIPROCAL``,
  ``FULL`` or None) names its spec (``layout_spec``) and its global
  extents (``layout_extents``).

Rank order is row-major over the mesh axes, as ``local_slices`` lists the
blocks and as the reference's partitioners number MPI ranks.  Uneven
extents take the ceil-division layout: the last block short or empty.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import perf


class Mesh:
    """Ranks of a process group laid out as ``shape`` (row-major), with
    axis names as the JAX package's meshes have them ("sp"; "p1", "p2")."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a Mesh needs an initialised torch.distributed process group "
                "(torch.distributed.init_process_group, or launch with torchrun)")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.group = group
        self.size = math.prod(self.shape)
        world = dist.get_world_size(group)
        if world != self.size:
            raise ValueError(f"mesh shape {self.shape} holds {self.size} ranks but "
                             f"the process group has {world}")
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.axis_groups = {}  # axis name -> the group along it (build_axis_groups)

    def build_axis_groups(self):
        """The process group of each mesh axis that this rank lies on: the
        ranks that differ from it in that axis' coordinate alone, in
        coordinate order (a pencil's column for "p1", its row for "p2").
        ``dist.new_group`` is collective over the default group, so every
        rank forms every group, in one order; an axis that spans the whole
        mesh takes the mesh's own group."""
        me = self.coords()
        for axis, name in enumerate(self.axis_names):
            if self.shape[axis] == self.size:
                self.axis_groups[name] = self.group
                continue
            others = [s for a, s in enumerate(self.shape) if a != axis]
            for rest in itertools.product(*[range(s) for s in others]):
                coords = list(rest)
                members = []
                for c in range(self.shape[axis]):
                    coords.insert(axis, c)
                    members.append(self.global_rank(self.rank_at(coords)))
                    coords.pop(axis)
                g = dist.new_group(members)
                if list(rest) == [c for a, c in enumerate(me) if a != axis]:
                    self.axis_groups[name] = g
        return self

    def axis_group(self, name: Optional[str]):
        """The group of mesh axis ``name`` (the whole mesh's for None)."""
        if name is None:
            return self.group
        if name not in self.axis_groups:
            raise RuntimeError(f"the mesh's '{name}' group was not formed "
                               "(parallel.make_mesh forms a pencil's groups)")
        return self.axis_groups[name]

    def coords(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The mesh coordinates of ``rank`` (this rank by default)."""
        return tuple(int(c) for c in np.unravel_index(
            self.rank if rank is None else rank, self.shape))

    def rank_at(self, coords: Sequence[int]) -> int:
        """The rank at ``coords``, each taken modulo its axis (periodic)."""
        return int(np.ravel_multi_index(
            tuple(c % s for c, s in zip(coords, self.shape)), self.shape))

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def neighbours(self, axis: int) -> Tuple[int, int]:
        """(previous, next) rank along mesh axis ``axis``, periodic."""
        c = list(self.coords())
        prev, nxt = list(c), list(c)
        prev[axis] -= 1
        nxt[axis] += 1
        return self.rank_at(prev), self.rank_at(nxt)

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank`` (p2p peers)."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"backend={self.backend}, rank={self.rank})")


def make_mesh(parallel_mode: str, group=None, shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of a parallel mode over ``group`` (the default group when
    None), by marlin_tpu/parallel.py:make_mesh's rules: 1-D ("sp",) for
    FFT_SLAB; ("p1", "p2") for FFT_PENCIL, near-square by default, with its
    row and column groups; a 1-D ("p1",), 2-D ("p1", "p2") or 3-D ("p1",
    "p2", "p3") block mesh for REAL_SPACE.  Every rank calls it, in the
    same order as its other collectives."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(torch.distributed.init_process_group, or launch with torchrun)")
    n = dist.get_world_size(group)
    if parallel_mode == "FFT_PENCIL":
        if shape is None:
            # near-square factorization (the reference picks factor pairs in
            # partitionPencils, DomainAction.C:568-616)
            p1 = int(math.floor(math.sqrt(n)))
            while n % p1:
                p1 -= 1
            shape = (p1, n // p1)
        return Mesh(shape, ("p1", "p2"), group).build_axis_groups()
    if parallel_mode == "REAL_SPACE":
        shape = (n,) if shape is None else tuple(shape)
        return Mesh(shape, ("p1", "p2", "p3")[:len(shape)], group)
    return Mesh((n,), ("sp",), group)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def real_spec(domain, ndim: int) -> Tuple[Optional[str], ...]:
    """The mesh axis name of each axis of a real-space field of rank
    ``ndim``, None where the axis is whole (marlin_tpu/parallel.py:77)."""
    dim = domain.dim
    spec = [None] * ndim
    mode = domain.parallel_mode
    if mode == "FFT_SLAB":
        # X-Z slabs stacked along Y (reference partitionSlabs)
        spec[1 if dim > 1 else 0] = "sp"
    elif mode == "FFT_PENCIL":
        spec[1], spec[2] = "p1", "p2"
    elif mode == "REAL_SPACE" and domain.mesh is not None:
        for i, name in enumerate(domain.mesh.axis_names[:dim]):
            spec[i] = name
    return tuple(spec)


def reciprocal_spec(domain, ndim: int) -> Tuple[Optional[str], ...]:
    """As ``real_spec`` for a reciprocal-space field: Y-Z slabs along X
    under FFT_SLAB (marlin_tpu/parallel.py:100)."""
    spec = [None] * ndim
    if domain.parallel_mode == "FFT_SLAB":
        spec[0] = "sp"
    elif domain.parallel_mode == "FFT_PENCIL":
        spec[0], spec[1] = "p1", "p2"
    return tuple(spec)


def chunk(n: int, parts: int, c: int) -> slice:
    """Block ``c`` of ``parts`` along an extent ``n``: the ceil-division
    layout (the last block short or empty)."""
    step = -(-n // parts)
    return slice(min(c * step, n), min((c + 1) * step, n))


def block_slices(mesh: Mesh, spec, shape: Sequence[int], rank: Optional[int] = None):
    """The slices of ``rank``'s block of a global array of ``shape`` laid
    out by ``spec`` (one mesh axis name or None an axis)."""
    coords = dict(zip(mesh.axis_names, mesh.coords(rank)))
    out = []
    for d, n in enumerate(shape):
        name = spec[d] if d < len(spec) else None
        if name is None:
            out.append(slice(0, n))
        else:
            out.append(chunk(n, mesh.axis_size(name), coords[name]))
    return tuple(out)


#: the layouts of a state leaf on a mesh (``Spec.layout``): a real-space
#: field, a spectrum laid out as the domain's transforms give it (half or,
#: under PALLAS, the full permuted one; a pencil's pad rows included), a
#: full spectrum of a complex field's ``fftn``; None is one value that
#: every rank holds whole
REAL, RECIPROCAL, FULL = "real", "reciprocal", "full"


def layout_spec(domain, layout: Optional[str], ndim: int, lead: int = 0):
    """The mesh axis of each axis of a leaf of ``layout`` with ``lead``
    axes before its spatial ones (a history stack's slot axis); none for
    a leaf with fewer axes than the grid (no field: whole on every
    rank)."""
    if layout is None or domain.mesh is None or ndim - lead < domain.dim:
        return (None,) * ndim
    spec = real_spec(domain, ndim - lead) if layout == REAL else \
        reciprocal_spec(domain, ndim - lead)
    return (None,) * lead + tuple(spec)


def layout_extents(domain, layout: Optional[str]) -> Tuple[int, ...]:
    """The global spatial extents of a leaf of ``layout``."""
    if layout == REAL:
        return tuple(domain.n_global)
    if layout == RECIPROCAL:
        return tuple(domain.global_reciprocal_shape)
    return tuple(domain.global_full_shape)


def gather_to(mesh: Mesh, t: torch.Tensor, spec, global_shape, root: int = 0,
              device=None) -> Optional[torch.Tensor]:
    """The global array of every rank's block ``t`` (laid out by ``spec``
    in the ceil-division layout, trailing axes past ``global_shape``
    kept) on rank ``root``, on ``device`` (``t``'s by default); None on
    the other ranks.  Each rank sends its block to ``root``, which takes
    them one at a time: no other rank holds the whole field, and ``root``
    holds it once and one block (``_gather`` gives every rank the whole
    field).  An empty block is neither sent nor received.  Every rank
    calls it, in the same order as its other collectives."""
    full = tuple(global_shape) + tuple(t.shape[len(global_shape):])
    me = mesh.rank
    if me != root:
        if t.numel():
            dist.send(_wire(t.contiguous()), mesh.global_rank(root), group=mesh.group)
        return None
    out = torch.empty(full, dtype=t.dtype, device=device or t.device)
    for r in range(mesh.size):
        sl = block_slices(mesh, spec, full, r)
        shape = [s.stop - s.start for s in sl]
        if not math.prod(shape):
            continue
        if r == me:
            block = t
        else:
            block = torch.empty(shape, dtype=t.dtype, device=t.device)
            dist.recv(_wire(block), mesh.global_rank(r), group=mesh.group)
        out[sl].copy_(block)  # across devices too, with no staging copy
    return out


def all_shapes(mesh: Mesh, shapes: Sequence[Tuple[int, ...]], device) -> List[List[tuple]]:
    """Every rank's ``shapes`` (a list of tensor shapes, the same count on
    every rank), in rank order, by one ``all_gather`` of a small integer
    tensor on ``device``."""
    width = max([len(s) for s in shapes] + [1])
    mine = torch.full((max(len(shapes), 1), width + 1), -1, dtype=torch.int64)
    for i, s in enumerate(shapes):
        mine[i, 0] = len(s)
        mine[i, 1:1 + len(s)] = torch.tensor(s, dtype=torch.int64)
    mine = mine.to(device)
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    return [[tuple(int(x) for x in row[1:1 + int(row[0])])
             for row in part.cpu()[:len(shapes)]] for part in parts]


def settle_layout(mesh: Mesh, spec, extents: Sequence[int], lead: int, shapes):
    """(spec, global shape) of a leaf laid out by ``spec`` whose spatial
    axes (after ``lead``) span ``extents``, from every rank's block shape
    (``shapes``, rank order): a cut axis whose blocks are the ceil-division
    blocks of its extent takes that extent; one whose blocks are all of
    extent 1 is a broadcast, whole on every rank.  Every rank that reads
    the same shapes settles the same way."""
    spec = list(spec)
    shape = list(shapes[0])
    for d, name in enumerate(spec):
        if name is None:
            continue
        n = extents[d - lead]
        parts = mesh.axis_size(name)
        blocks = [chunk(n, parts, dict(zip(mesh.axis_names, mesh.coords(r)))[name])
                  for r in range(mesh.size)]
        if all(s[d] == b.stop - b.start for s, b in zip(shapes, blocks)):
            shape[d] = n
        elif all(s[d] == 1 for s in shapes):
            spec[d] = None
        else:
            raise ValueError(f"a leaf of block shapes {shapes} is not laid out along "
                             f"axis {d} as '{name}' over {n} (its recorded layout "
                             "is wrong)")
    return tuple(spec), tuple(shape)


def block_of(mesh: Mesh, global_array, spec):
    """This rank's block of ``global_array`` (numpy or torch) laid out by
    ``spec``, through ``block_slices``; an empty block where the
    ceil-division layout leaves this rank none."""
    return global_array[block_slices(mesh, spec, global_array.shape)]


def local_slices(domain) -> List[tuple]:
    """Per-rank slices of a real-space cell array, in rank order
    (marlin_tpu/parallel.py:213, the analog of the reference's
    getLocalBounds)."""
    mesh = domain.mesh
    dim = domain.dim
    if mesh is None:
        return [tuple(slice(None) for _ in range(dim))]
    spec = real_spec(domain, dim)
    counts = [mesh.axis_size(spec[d]) if spec[d] else 1 for d in range(dim)]
    sharded = [d for d in range(dim) if counts[d] > 1]
    out = []
    for coords in itertools.product(*[range(counts[d]) for d in sharded]):
        idx = [slice(None)] * dim
        for d, c in zip(sharded, coords):
            idx[d] = chunk(domain.n_global[d], counts[d], c)
        out.append(tuple(idx))
    if not out:
        out = [tuple(slice(None) for _ in range(dim))]
    if len(out) != mesh.size:
        raise ValueError(
            f"local_slices: the real-space sharding spec yields {len(out)} "
            f"chunk(s) but the mesh has {mesh.size} devices; per-rank output "
            "requires one chunk per device (shrink the mesh or shard more "
            "axes)"
        )
    return out


def validate_mesh(domain):
    """Build-time divisibility check, in marlin_tpu/parallel.py:162's
    words.  FFT_SLAB and REAL_SPACE accept uneven grids (``domain.uneven``:
    the slab transforms then take the gather path); FFT_PENCIL needs even
    tiles; PALLAS needs a grid the mesh divides."""
    domain.uneven = False
    mesh = domain.mesh
    if mesh is None or domain.parallel_mode == "NONE":
        return
    strict = domain.parallel_mode == "FFT_PENCIL"

    def check(shape, spec, what):
        for d in range(domain.dim):
            name = spec[d] if d < len(spec) else None
            n_dev = mesh.axis_size(name) if name else 1
            if n_dev > 1 and shape[d] % n_dev:
                if not strict:
                    domain.uneven = True
                    continue
                raise ValueError(
                    f"[Domain] {what} extent {shape[d]} along axis {d} does "
                    f"not divide evenly over the {n_dev}-device mesh axis "
                    f"'{name}' ({domain.parallel_mode} mode requires "
                    "even tiles; choose grid sizes divisible by the device "
                    "counts, or use FFT_SLAB which accepts uneven grids)"
                )

    check(domain.n_global, real_spec(domain, domain.dim), "real-space grid")
    if domain.parallel_mode in ("FFT_SLAB", "FFT_PENCIL"):
        check(domain.global_reciprocal_shape, reciprocal_spec(domain, domain.dim),
              "reciprocal-space grid")
    if domain.uneven and domain.fft_backend == "PALLAS":
        raise ValueError(
            "[Domain] fft_backend = PALLAS requires grid extents divisible "
            "by the mesh (the Pallas slab path uses explicit even-tile "
            "transposes); use the DEFAULT backend for uneven grids"
        )


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its real view (NCCL and gloo move real words)."""
    return torch.view_as_real(t) if t.is_complex() else t


def all_to_all(mesh: Mesh, t: torch.Tensor, split_axis: int, concat_axis: int,
               axis: Optional[str] = None) -> torch.Tensor:
    """``jax.lax.all_to_all(t, axis, split_axis, concat_axis, tiled=True)``:
    ``t`` is cut into p tiles along ``split_axis``, tile j goes to rank j
    of the group, and the tiles received are joined along ``concat_axis``
    in rank order.  The group is mesh axis ``axis``'s, or the whole mesh's
    for None.  One ``all_to_all_single`` of the tiles made contiguous."""
    group = mesh.axis_group(axis)
    p = dist.get_world_size(group)
    shape = list(t.shape)
    if shape[split_axis] % p:
        raise ValueError(f"all_to_all: extent {shape[split_axis]} along axis "
                         f"{split_axis} does not divide over {p} ranks")
    tile = shape[:split_axis] + [shape[split_axis] // p] + shape[split_axis + 1:]
    send = t.reshape(shape[:split_axis] + [p] + tile[split_axis:]).movedim(
        split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    with perf.span("parallel::all_to_all"):
        dist.all_to_all_single(_wire(recv), _wire(send), group=group)
    all_to_all.calls += 1
    joined = recv.movedim(0, concat_axis)
    out = list(tile)
    out[concat_axis] *= p
    return joined.reshape(out)


all_to_all.calls = 0


def _gather(mesh: Mesh, t: torch.Tensor, spec, global_shape) -> torch.Tensor:
    """The global array from every rank's block (``spec`` as
    ``real_spec``): blocks padded to the ceil-division tile, one
    ``all_gather``, the padding cut off."""
    sharded = [(d, name) for d, name in enumerate(spec) if name is not None]
    padded_shape = list(t.shape)
    for d, name in sharded:
        padded_shape[d] = -(-global_shape[d] // mesh.axis_size(name))
    buf = t.new_zeros(padded_shape)
    buf[tuple(slice(0, s) for s in t.shape)] = t
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather([_wire(x) for x in parts], _wire(buf), group=mesh.group)
    out = t.new_zeros(list(global_shape) + list(t.shape[len(global_shape):]))
    for r, part in enumerate(parts):
        sl = block_slices(mesh, spec, global_shape, r)
        out[sl] = part[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def all_reduce(mesh: Optional[Mesh], t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the mesh's group (sum, max, min, or "nanmax": the
    max, NaN where any rank's ``t`` is, as ``torch.max`` of the whole
    would give); ``t`` itself without a mesh.  A new tensor: the caller's
    is not written.  One collective whatever the op."""
    if mesh is None:
        return t
    if op == "nanmax":
        nan = t.isnan()
        both = all_reduce(mesh, torch.stack([t.masked_fill(nan, -math.inf),
                                             nan.to(t.dtype)]), "max")
        return torch.where(both[1] > 0, math.nan, both[0])
    out = t.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    with perf.span("parallel::all_reduce"):
        dist.all_reduce(_wire(out) if op == "sum" else out, op=red, group=mesh.group)
    all_reduce.calls += 1
    return out


all_reduce.calls = 0


def exchange(mesh: Mesh, axis: int, to_next: Optional[torch.Tensor],
             to_prev: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor],
                                                       Optional[torch.Tensor]]:
    """One neighbour exchange along mesh axis ``axis``: ``to_next`` goes to
    the next rank and ``to_prev`` to the previous one; returns (what the
    previous rank sent to its next, what the next rank sent to its
    previous).  A neighbour that is this rank itself is a local copy; the
    others go by one ``batch_isend_irecv``, sends and receives listed in
    the same order on every rank so that two messages between one pair
    (a ring of two) match in order, and tagged for gloo."""
    prev, nxt = mesh.neighbours(axis)
    me = mesh.rank
    from_prev = None if to_next is None else torch.empty_like(to_next)
    from_next = None if to_prev is None else torch.empty_like(to_prev)
    ops = []
    if to_next is not None:
        if nxt == me:
            from_prev.copy_(to_next)
        else:
            ops.append(dist.P2POp(dist.isend, _wire(to_next.contiguous()),
                                  mesh.global_rank(nxt), mesh.group, tag=0))
    if to_prev is not None:
        if prev == me:
            from_next.copy_(to_prev)
        else:
            ops.append(dist.P2POp(dist.isend, _wire(to_prev.contiguous()),
                                  mesh.global_rank(prev), mesh.group, tag=1))
    if to_next is not None and prev != me:
        ops.append(dist.P2POp(dist.irecv, _wire(from_prev), mesh.global_rank(prev),
                              mesh.group, tag=0))
    if to_prev is not None and nxt != me:
        ops.append(dist.P2POp(dist.irecv, _wire(from_next), mesh.global_rank(nxt),
                              mesh.group, tag=1))
    if ops:
        with perf.span("parallel::exchange"):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    exchange.calls += 1
    return from_prev, from_next


exchange.calls = 0


def barrier(mesh: Optional[Mesh]):
    """Every rank of ``mesh`` waits for the others (nothing without one)."""
    if mesh is not None:
        dist.barrier(group=mesh.group)


def reset_calls():
    for fn in (all_to_all, all_reduce, exchange):
        fn.calls = 0


def calls() -> Dict[str, int]:
    """The collectives made since ``reset_calls``, by kind."""
    return {fn.__name__: fn.calls for fn in (all_to_all, all_reduce, exchange)}


# ---------------------------------------------------------------------------
# halos (REAL_SPACE)
# ---------------------------------------------------------------------------


def shifted(p: torch.Tensor, shifts: Sequence[int], dims: Sequence[int],
            halo_dims: Sequence[int], width: int = 1) -> torch.Tensor:
    """``torch.roll(t, shifts, dims)`` of the field ``t`` that ``halo_pad``
    (or ``ring_to_padded``) extended by ``width`` planes on each side of
    ``halo_dims``: a slice there (|shift| ≤ width), a roll elsewhere."""
    out = p
    for s, d in zip(shifts, dims):
        if d in halo_dims:
            if abs(s) > width:
                raise ValueError(f"a sharded roll takes shifts of at most {width} "
                                 f"plane(s) (got {s} along axis {d})")
            out = out.narrow(d, width - s, p.shape[d] - 2 * width)
        elif s:
            out = torch.roll(out, s, d)
    for d in halo_dims:
        if d not in dims:
            out = out.narrow(d, width, p.shape[d] - 2 * width)
    return out


def halo_pad(mesh: Mesh, t: torch.Tensor, lead: int, cuts: Sequence[Tuple[int, int]],
             width: int = 1) -> torch.Tensor:
    """``t`` (``lead`` axes before its spatial ones) with ``width`` planes
    of its neighbours' on each side of every cut spatial axis, ``cuts``
    the (spatial axis, mesh axis) pairs, the periodic wrap where the
    neighbour is this rank: one ``exchange`` a cut, each of the block
    extended by the cuts before it, so that edges and corners come from
    the diagonal neighbours."""
    for axis, mesh_axis in cuts:
        d = lead + axis
        n = t.shape[d]
        if n < width:
            raise ValueError(f"a block of {n} plane(s) along axis {axis} cannot "
                             f"give its neighbours a halo of {width}")
        lo, hi = exchange(mesh, mesh_axis, t.narrow(d, n - width, width),
                          t.narrow(d, 0, width))
        t = torch.cat([lo, t, hi], dim=d)
    return t


def halo_ring(mesh: Mesh, t: torch.Tensor, x_dim: int, shard_y: bool) -> torch.Tensor:
    """The halo a block of the fused LBM kernel reads, as one contiguous
    ring (lead..., H) with, per lead index: the x-lo plane (the previous
    x rank's last plane, ny·nz), the x-hi plane (ny·nz), and on a 2-D mesh
    the y-lo row (nx·nz), the y-hi row (nx·nz) and the four corner columns
    (x-lo/y-lo, x-lo/y-hi, x-hi/y-lo, x-hi/y-hi, nz each).  ``t`` is
    (lead..., nx, ny, nz) with x at ``x_dim`` (the counterpart of
    pallas_lbm.py:958-998 ``_exchange_xy``)."""
    nx = t.shape[x_dim]
    xlo, xhi = exchange(mesh, 0, t.select(x_dim, nx - 1), t.select(x_dim, 0))
    return ring_pack(t, xlo, xhi, x_dim, shard_y,
                     lambda lo, hi: exchange(mesh, 1, lo, hi) if shard_y else None)


def ring_pack(t, xlo, xhi, x_dim: int, shard_y: bool, y_exchange):
    """The ring of ``halo_ring`` from the x planes and, on a 2-D mesh, the
    y exchange of the x-extended boundary rows (``y_exchange(to_next,
    to_prev)``)."""
    lead = t.shape[:x_dim]
    parts = [xlo.reshape(lead + (-1,)), xhi.reshape(lead + (-1,))]
    if shard_y:
        y = x_dim + 1
        ny = t.shape[y]
        ext = torch.cat([xlo.unsqueeze(x_dim), t, xhi.unsqueeze(x_dim)], dim=x_dim)
        ylo, yhi = y_exchange(ext.select(y, ny - 1), ext.select(y, 0))
        nx = t.shape[x_dim]
        for row in (ylo, yhi):
            parts.append(row.narrow(x_dim, 1, nx).reshape(lead + (-1,)))
        for row in ((ylo, 0), (yhi, 0), (ylo, nx + 1), (yhi, nx + 1)):
            parts.append(row[0].select(x_dim, row[1]).reshape(lead + (-1,)))
    return torch.cat(parts, dim=-1).contiguous()


def ring_size(nx: int, ny: int, nz: int, shard_y: bool) -> int:
    """H, the values of ``halo_ring`` a lead index."""
    return 2 * ny * nz + ((2 * nx + 4) * nz if shard_y else 0)


def ring_to_padded(t: torch.Tensor, ring: torch.Tensor, x_dim: int,
                   shard_y: bool) -> torch.Tensor:
    """``t`` (lead..., nx, ny, nz) extended by its ring: (lead..., nx + 2,
    ny (+ 2 on a 2-D mesh), nz), the corners of a 2-D mesh from the
    diagonal neighbour."""
    lead = t.shape[:x_dim]
    nx, ny, nz = t.shape[x_dim:x_dim + 3]
    o = 0

    def take(count, shape):
        nonlocal o
        part = ring[..., o:o + count].reshape(lead + shape)
        o += count
        return part

    xlo = take(ny * nz, (1, ny, nz))
    xhi = take(ny * nz, (1, ny, nz))
    ext = torch.cat([xlo, t, xhi], dim=x_dim)
    if not shard_y:
        return ext
    ylo = take(nx * nz, (nx, 1, nz))
    yhi = take(nx * nz, (nx, 1, nz))
    corners = [take(nz, (1, 1, nz)) for _ in range(4)]
    lo_row = torch.cat([corners[0], ylo, corners[2]], dim=x_dim)
    hi_row = torch.cat([corners[1], yhi, corners[3]], dim=x_dim)
    return torch.cat([lo_row, ext, hi_row], dim=x_dim + 1)


# ---------------------------------------------------------------------------
# distributed transforms
# ---------------------------------------------------------------------------


def fft(domain, x: torch.Tensor) -> torch.Tensor:
    if domain.parallel_mode == "FFT_SLAB":
        if domain.fft_backend == "PALLAS":
            return fft_slab_pallas(domain, x)
        return fft_slab(domain, x)
    if domain.parallel_mode == "FFT_PENCIL":
        return fft_pencil(domain, x)
    raise RuntimeError(f"No distributed FFT for mode {domain.parallel_mode}")


def ifft(domain, x: torch.Tensor) -> torch.Tensor:
    if domain.parallel_mode == "FFT_SLAB":
        if domain.fft_backend == "PALLAS":
            return ifft_slab_pallas(domain, x)
        return ifft_slab(domain, x)
    if domain.parallel_mode == "FFT_PENCIL":
        return ifft_pencil(domain, x)
    raise RuntimeError(f"No distributed iFFT for mode {domain.parallel_mode}")


def _real_ends(z: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``z`` with the imaginary part of its zero and (even ``n``) Nyquist
    entries along the half axis ``axis`` dropped, before the c2r transform
    along it: what a c2r reads of them whatever the library, and what a
    spectrum Hermitian in the other axes holds there after their inverse
    transforms (so a non-Hermitian end plane inverts as the serial path's
    Hermitian fix of it does)."""
    for idx in (0, n // 2) if n % 2 == 0 else (0,):
        z.select(axis, idx).imag.zero_()
    return z


def fft_slab(domain, x: torch.Tensor) -> torch.Tensor:
    """Forward slab FFT (reference fftSlab, DomainAction.C:869-938;
    marlin_tpu/parallel.py:307): the local transforms, one all_to_all from
    Y-stacked to X-stacked slabs, the transform along y.  Real 3-D input
    rfft's z; complex input and 2-D grids keep the full spectrum."""
    dim = domain.dim
    if dim == 1 or domain.uneven:
        return _gather_fft(domain, x)
    if dim == 3 and not x.is_complex():
        z = torch.fft.rfft(x, dim=2)
        z = torch.fft.fft(z, dim=0)
    else:
        z = x.to(domain.cdtype) if not x.is_complex() else x
        for a in range(dim):
            if a != 1:
                z = torch.fft.fft(z, dim=a)
    z = all_to_all(domain.mesh, z, 0, 1)
    return torch.fft.fft(z, dim=1).to(domain.cdtype)


def ifft_slab(domain, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fft_slab`` (marlin_tpu/parallel.py:353); a half-z
    spectrum is told from a full one by its z extent."""
    dim = domain.dim
    if dim == 1 or domain.uneven:
        return _gather_ifft(domain, x)
    half_z = (dim == 3 and domain.use_rfft(2)
              and x.shape[2] == domain.global_reciprocal_shape[2])
    z = torch.fft.ifft(x, dim=1)
    z = all_to_all(domain.mesh, z, 1, 0)
    z = torch.fft.ifft(z, dim=0)
    if half_z:
        nz = domain.n_global[2]
        return torch.fft.irfft(_real_ends(z, 2, nz), n=nz, dim=2).to(domain.dtype)
    for a in range(2, dim):
        z = torch.fft.ifft(z, dim=a)
    return z.real.to(domain.dtype)


def _gather_fft(domain, x: torch.Tensor) -> torch.Tensor:
    """Uneven-grid (and 1-D) slab transform (marlin_tpu/parallel.py:386):
    gather the field, transform it whole, keep this rank's slice of the
    reciprocal layout."""
    mesh = domain.mesh
    spatial = tuple(range(domain.dim))
    g = _gather(mesh, x, real_spec(domain, x.ndim), domain.n_global)
    if x.is_complex():
        z = torch.fft.fftn(g, dim=spatial)
    elif domain.dim == 3 and domain.use_rfft(2):
        z = torch.fft.rfftn(g, dim=spatial)
    else:
        z = torch.fft.fftn(g.to(domain.cdtype), dim=spatial)
    sl = block_slices(mesh, reciprocal_spec(domain, z.ndim), z.shape)
    return z[sl].to(domain.cdtype).contiguous()


def _gather_ifft(domain, x: torch.Tensor) -> torch.Tensor:
    mesh = domain.mesh
    dim = domain.dim
    spatial = tuple(range(dim))
    # axis 0 is never the half axis of a slab spectrum
    shape = (domain.global_reciprocal_shape[0],) + tuple(x.shape[1:dim])
    g = _gather(mesh, x, reciprocal_spec(domain, x.ndim), shape)
    if dim == 3 and domain.use_rfft(2) and x.shape[2] == domain.global_reciprocal_shape[2]:
        r = torch.fft.irfftn(g, s=domain.n_global, dim=spatial)
    else:
        r = torch.fft.ifftn(g, dim=spatial).real
    sl = block_slices(mesh, real_spec(domain, r.ndim), r.shape)
    return r[sl].to(domain.dtype).contiguous()


def fft_pencil(domain, x: torch.Tensor) -> torch.Tensor:
    """Forward pencil FFT (reference fftPencil, DomainAction.C:1021-1404;
    marlin_tpu/parallel.py:434): the local rfft along x, its half extent
    zero-padded to the p1 tile multiple (the pad rows stay exact zeros
    through the linear stages), one all_to_all over p1, the y transform,
    one over p2, the z transform.  Complex input keeps the full spectrum
    and needs nx divisible by p1."""
    mesh = domain.mesh
    if x.is_complex():
        p1 = mesh.axis_size("p1")
        if domain.n_global[0] % p1:
            raise ValueError(
                f"FFT_PENCIL full-spectrum (complex-input) transform needs "
                f"nx={domain.n_global[0]} divisible by the p1 mesh axis ({p1})"
            )
        z = torch.fft.fft(x.to(domain.cdtype), dim=0)
    else:
        z = torch.fft.rfft(x, dim=0)
        if domain.reciprocal_pad:
            z = torch.cat([z, z.new_zeros((domain.reciprocal_pad,) + z.shape[1:])], 0)
    z = all_to_all(mesh, z, 0, 1, "p1")
    z = torch.fft.fft(z, dim=1)
    z = all_to_all(mesh, z, 1, 2, "p2")
    return torch.fft.fft(z, dim=2).to(domain.cdtype)


def ifft_pencil(domain, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fft_pencil`` (marlin_tpu/parallel.py:478): the z
    transform, the all_to_all back over p2, y, back over p1, then the pad
    rows cut off and the c2r along x.  A half-x spectrum is told from a
    full one by its x extent (the tiny-grid pad keeps them apart)."""
    mesh = domain.mesh
    half_x = domain.use_rfft(0) and x.shape[0] == domain.reciprocal_shape[0]
    z = torch.fft.ifft(x, dim=2)
    z = all_to_all(mesh, z, 2, 1, "p2")
    z = torch.fft.ifft(z, dim=1)
    z = all_to_all(mesh, z, 1, 0, "p1")
    if half_x:
        nx = domain.n_global[0]
        z = _real_ends(z[:nx // 2 + 1], 0, nx)
        return torch.fft.irfft(z, n=nx, dim=0).to(domain.dtype)
    return torch.fft.ifft(z, dim=0).real.to(domain.dtype)


def fft_slab_pallas(domain, x: torch.Tensor) -> torch.Tensor:
    """Slab-distributed unordered FFT of a 3-D scalar field
    (marlin_tpu/parallel.py:508): kernels 1 (z) and 3 (x) on the Y-sharded
    block (nx, ny/p, nz), one all_to_all, kernel 3 along y on the
    X-sharded block (nx/p, ny, nz).  The spectrum is the serial PALLAS
    backend's permuted full-complex layout, cut along x."""
    from . import unordered_fft as uf

    u = uf.fwd_axes(x.to(torch.complex64 if x.is_complex() else torch.float32), (0, 2))
    u = all_to_all(domain.mesh, u, 0, 1)
    return uf.fwd_sublanes(u.contiguous()).to(domain.cdtype)


def ifft_slab_pallas(domain, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fft_slab_pallas`` (marlin_tpu/parallel.py:536): kernel
    4 along y on the X-sharded block, the all_to_all back, kernel 4 along
    x and kernel 2 along z with the real part out."""
    from . import unordered_fft as uf

    u = uf.inv_sublanes(x.to(torch.complex64).contiguous())
    u = all_to_all(domain.mesh, u, 1, 0)
    return uf.inv_axes(u, (0, 2), real_output=True).to(domain.dtype)
