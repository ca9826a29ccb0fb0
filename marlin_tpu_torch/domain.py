"""Domain: grid geometry, real/reciprocal axes, FFT dispatch, device mesh.

The PyTorch counterpart of marlin_tpu/domain.py.  The
semantic choices of the reference DomainAction are kept
(reference: src/actions/DomainAction.C — axes :226-338, fft/ifft :833-1078):

- real-space axes are cell-centered: linspace(min+h/2, max-h/2, n);
- reciprocal axes are ``(r)fftfreq(n, h) * 2*pi`` with the rfft half
  spectrum along the LAST dimension; the Nyquist frequency is not zeroed;
- axes are broadcast-aligned: axis d has extent n_d along dim d;
- ``fft`` is an unnormalized forward real FFT, ``ifft`` carries the 1/N.

``fft_backend = DEFAULT`` transforms with ``torch.fft.rfftn``/``irfftn``.
``fft_backend = PALLAS`` (the JAX package's name, kept so decks run
unchanged) transforms with the unordered-FFT kernels of ``unordered_fft``:
the full complex spectrum in permuted order along every axis, with
reciprocal axes from ``permuted_freqs``.  It keeps the JAX package's three
rejections: serial mode and 3-D FFT_SLAB only, float32 only, and extents
by ``supported()``.  A tensor-valued field (trailing value axes, as
``batched_transform`` stacks them) transforms with its value axes moved to
the front, where they join the rows of the lanes kernels and the prefix of
the sublanes kernels: one launch of each kernel an axis, whatever the
number of fields
(marlin_tpu/domain.py:420-441 forward, :492-511 inverse).

``parallel_mode = FFT_SLAB``, ``FFT_PENCIL`` and ``REAL_SPACE`` run over a
``parallel.Mesh`` of ranks: the Domain then holds the global extents
(``n_global``) and this rank's block of them (``real_slice``,
``reciprocal_slice``), and ``shape``, ``reciprocal_shape``, the axes and
the k-tables are the block's, so that every compute works on the local
block as it would on the whole grid.  ``fft``/``ifft`` go through
``parallel.fft``/``ifft``, ``sum``/``average`` reduce over the group.  A
pencil's half spectrum is along x, padded with ``reciprocal_pad`` rows of
k = 0 to a multiple of p1 (``spectrum``: a block without them).  Without
a mesh a parallel-mode deck runs its layouts on one device, as the JAX
package does with ``mesh=None``: 3-D FFT_SLAB rfft's z as serial mode
does, 2-D FFT_SLAB keeps the full spectrum, FFT_PENCIL rfft's x
(``rfftn`` over the axes (1, 2, 0), no pad).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import parallel, unordered_fft
from .device import COMPLEX_FOR, default_float_dtype, resolve

PARALLEL_MODES = ("NONE", "REAL_SPACE", "FFT_SLAB", "FFT_PENCIL")


def batched_transform(op, pairs):
    """{key: op(t)} for ``pairs = [(key, t), ...]``: fields of the same
    shape and complexness are stacked on a trailing value axis and
    transformed in one call; a field alone in its group takes the plain
    path (marlin_tpu/domain.py:batched_transform).  The one batching rule
    of ``[Problem] batch_fft = true``, for core.BatchedFFT and the
    solvers' inverse transforms alike."""
    groups = {}
    for k, t in pairs:
        groups.setdefault((tuple(t.shape), t.is_complex()), []).append((k, t))
    out = {}
    for items in groups.values():
        if len(items) == 1:
            k, t = items[0]
            out[k] = op(t)
        else:
            res = op(torch.stack([t for _, t in items], dim=-1))
            for i, (k, _) in enumerate(items):
                out[k] = res[..., i]
    return out
PRECISIONS = ("DEVICE_DEFAULT", "SINGLE", "DOUBLE")
FFT_BACKENDS = ("DEFAULT", "PALLAS")


class Domain:
    """Uniform periodic grid with spectral transforms, on one device or one
    rank's block of a mesh.

    Parameters mirror the reference ``[Domain]`` block
    (reference: src/actions/DomainAction.C:29-92)."""

    def __init__(
        self,
        dim: int,
        n: Sequence[int],
        mins: Sequence[float] = (0.0, 0.0, 0.0),
        maxs: Sequence[float] = (1.0, 1.0, 1.0),
        parallel_mode: str = "NONE",
        floating_precision: str = "DEVICE_DEFAULT",
        fft_backend: str = "DEFAULT",
        device=None,
        mesh: Optional["parallel.Mesh"] = None,
        debug: bool = False,
    ):
        if dim not in (1, 2, 3):
            raise ValueError(f"Unsupported dimension {dim}")
        if parallel_mode not in PARALLEL_MODES:
            raise ValueError(f"[Domain] parallel_mode = {parallel_mode} is not one "
                             f"of {PARALLEL_MODES}")
        if parallel_mode == "FFT_PENCIL" and dim != 3:
            # reference DomainAction.C:572 (marlin_tpu/domain.py:128-132)
            raise ValueError("Dimension must be 3 for pencil decomposition.")
        self.dim = dim
        self.device = resolve(device)
        self.n_global = tuple(int(x) for x in n[:dim])
        self.mins = tuple(float(x) for x in mins[:dim])
        self.maxs = tuple(float(x) for x in maxs[:dim])
        self.parallel_mode = parallel_mode
        self.mesh = mesh if parallel_mode != "NONE" else None
        self.debug = debug
        self.fft_backend = fft_backend
        self.uneven = False
        if self.mesh is not None:
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if self.mesh.backend != want:
                raise ValueError(
                    f"[Domain] the mesh's process group is {self.mesh.backend} but "
                    f"the domain's device is {self.device} (NCCL on the card, "
                    "gloo on the CPU)")
            if parallel_mode == "REAL_SPACE" and len(self.mesh.shape) > dim:
                raise ValueError(
                    f"[Domain] a {len(self.mesh.shape)}-D REAL_SPACE mesh does "
                    f"not fit a {dim}-D grid")
        if fft_backend == "PALLAS":
            if parallel_mode not in ("NONE", "FFT_SLAB") \
                    or (parallel_mode == "FFT_SLAB" and dim != 3):
                raise ValueError(
                    "[Domain] fft_backend = PALLAS supports serial mode and "
                    "3-D FFT_SLAB (z and x kernels run per-shard, one planar "
                    "all_to_all, y kernel after the transpose); use the "
                    "DEFAULT backend for pencil/2-D-slab decompositions"
                )
            bad = [x for x in self.n_global if not unordered_fft.supported(x)]
            if bad:
                raise ValueError(
                    f"[Domain] fft_backend = PALLAS requires every grid "
                    f"extent to factor as {unordered_fft.SUPPORTED_RULE}; "
                    f"got {bad}"
                )
            if parallel_mode == "FFT_SLAB" and self.mesh is not None:
                reason = unordered_fft.slab_grid_unsupported_reason(
                    self.n_global, self.mesh.size)
                if reason:
                    raise ValueError(
                        f"[Domain] fft_backend = PALLAS cannot tile this "
                        f"grid: {reason}"
                    )
            if floating_precision == "DOUBLE":
                raise ValueError(
                    "[Domain] fft_backend = PALLAS is single-precision "
                    "(float32 kernels); use floating_precision = SINGLE "
                    "or the DEFAULT backend for f64"
                )
        for d in range(dim):
            if self.maxs[d] <= self.mins[d]:
                raise ValueError(
                    "Max coordinate must be larger than the min coordinate "
                    "in every dimension"
                )

        self.dtype = default_float_dtype(floating_precision, self.device)
        self.cdtype = COMPLEX_FOR[self.dtype]
        self.grid_spacing = tuple(
            (self.maxs[d] - self.mins[d]) / self.n_global[d] for d in range(dim)
        )
        self.volume_global = math.prod(
            self.maxs[d] - self.mins[d] for d in range(dim)
        )
        self.n_cells_global = math.prod(self.n_global)
        self._cells_t = {}  # dtype -> N as a 0-d device tensor (ifft)
        self._build_axes()
        if self.mesh is not None:
            parallel.validate_mesh(self)

    # -- axes -------------------------------------------------------------
    def use_rfft(self, d: int) -> bool:
        """Which axis carries the half spectrum (marlin_tpu/domain.py
        _use_rfft): the last in serial mode, z on 3-D FFT_SLAB grids (z is
        whole in both slab layouts), x on FFT_PENCIL (the reference's own
        convention, DomainAction.C:279-284), none on 2-D FFT_SLAB,
        REAL_SPACE or PALLAS (the full permuted spectrum)."""
        if self.fft_backend == "PALLAS":
            return False
        if self.parallel_mode == "NONE":
            return d == self.dim - 1
        if self.parallel_mode == "FFT_SLAB":
            # nz > 2 keeps the half extent distinct from nz, so the inverse
            # can tell half from full spectra by shape
            return self.dim == 3 and d == 2 and self.n_global[2] > 2
        if self.parallel_mode == "FFT_PENCIL":
            return d == 0 and self.n_global[0] > 2
        return False

    def _pencil_pad(self, half: int) -> int:
        """The zero rows that pad a pencil's half extent ``half`` to a
        multiple of p1 (marlin_tpu/domain.py:251-292): one more tile where
        the padded extent would equal nx, so that the inverse still tells
        a half spectrum from a full one by its extent."""
        p1 = self.mesh.axis_size("p1")
        pad = (-half) % p1
        if half + pad == self.n_global[0]:
            pad += p1
        self.reciprocal_pad = pad
        return pad

    def _build_axes(self):
        self.reciprocal_pad = 0
        #: the spatial axis of the half spectrum, None for a full one
        self.half_axis = next((d for d in range(self.dim) if self.use_rfft(d)), None)
        npdtype = np.float64 if self.dtype == torch.float64 else np.float32
        self._np_axes_global = []
        self._np_raxes_global = []
        for d in range(self.dim):
            h = self.grid_spacing[d]
            n = self.n_global[d]
            self._np_axes_global.append(np.linspace(
                self.mins[d] + h / 2.0, self.maxs[d] - h / 2.0, n).astype(npdtype))
            if self.parallel_mode == "REAL_SPACE":
                freq = np.zeros((0,))  # no spectral axes (marlin_tpu/domain.py:267)
            elif self.fft_backend == "PALLAS":
                # full complex spectrum in the kernels' permuted order
                freq = unordered_fft.permuted_freqs(n, d=h)
            elif self.use_rfft(d):
                freq = np.fft.rfftfreq(n, d=h)
                if self.parallel_mode == "FFT_PENCIL" and self.mesh is not None:
                    freq = np.concatenate([freq, np.zeros(self._pencil_pad(len(freq)))])
            else:
                freq = np.fft.fftfreq(n, d=h)
            self._np_raxes_global.append((freq * 2.0 * math.pi).astype(npdtype))
        self.global_reciprocal_shape = tuple(k.shape[0] for k in self._np_raxes_global)
        # the full (not halved) spectrum's extents, which fftn of a complex
        # field gives
        self.global_full_shape = tuple(
            self.n_global[d] if self.use_rfft(d) else self.global_reciprocal_shape[d]
            for d in range(self.dim))
        if self.mesh is not None:
            self.real_slice = parallel.block_slices(
                self.mesh, parallel.real_spec(self, self.dim), self.n_global)
            self.reciprocal_slice = parallel.block_slices(
                self.mesh, parallel.reciprocal_spec(self, self.dim),
                self.global_reciprocal_shape)
            self.full_slice = parallel.block_slices(
                self.mesh, parallel.reciprocal_spec(self, self.dim), self.global_full_shape)
        else:
            self.real_slice = tuple(slice(0, n) for n in self.n_global)
            self.reciprocal_slice = tuple(slice(0, n) for n in self.global_reciprocal_shape)
            self.full_slice = tuple(slice(0, n) for n in self.global_full_shape)
        self.axes = []  # real-space, aligned tensors on the device
        self._np_axes = []  # unaligned 1-D numpy (host-side initial conditions)
        self.reciprocal_axes = []
        self._np_raxes = []  # unaligned 1-D numpy
        for d in range(self.dim):
            ax = self._np_axes_global[d][self.real_slice[d]]
            self._np_axes.append(ax)
            self.axes.append(self._aligned(ax, d))
            k = self._np_raxes_global[d][self.reciprocal_slice[d]]
            self._np_raxes.append(k)
            self.reciprocal_axes.append(self._aligned(k, d))
        self.n_reciprocal_global = list(self.global_reciprocal_shape)

    def _np_align(self, a: np.ndarray, d: int) -> np.ndarray:
        shape = [1] * self.dim
        shape[d] = a.shape[0]
        return a.reshape(shape)

    def _aligned(self, a: np.ndarray, d: int) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(self._np_align(a, d))).to(self.device)

    # -- shapes -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        """This rank's real-space block (the whole grid without a mesh)."""
        return tuple(s.stop - s.start for s in self.real_slice)

    @property
    def reciprocal_shape(self) -> Tuple[int, ...]:
        """This rank's reciprocal-space block."""
        return tuple(s.stop - s.start for s in self.reciprocal_slice)

    def value_shape(self, extra_dims: Sequence[int] = ()) -> Tuple[int, ...]:
        return self.shape + tuple(extra_dims)

    def reciprocal_value_shape(self, extra_dims: Sequence[int] = ()) -> Tuple[int, ...]:
        return self.reciprocal_shape + tuple(extra_dims)

    def local(self, a):
        """This rank's block of a global real-space array (numpy or torch;
        trailing value axes kept)."""
        return a[self.real_slice]

    # -- derived grids ----------------------------------------------------
    @property
    def k_square(self) -> torch.Tensor:
        """|k|² over the reciprocal grid (reference :1503-1510), built on
        demand from the 1-D axes and never cached (marlin_tpu/domain.py:329)."""
        ks = self._aligned(self._np_raxes[0] ** 2, 0)
        for d in range(1, self.dim):
            ks = ks + self._aligned(self._np_raxes[d] ** 2, d)
        return ks

    def np_k_square(self) -> np.ndarray:
        """|k|² as a full-grid numpy array, for host-side consumers
        (marlin_tpu/domain.py:np_k_square)."""
        ks = self._np_align(self._np_raxes[0] ** 2, 0)
        for d in range(1, self.dim):
            ks = ks + self._np_align(self._np_raxes[d] ** 2, d)
        return np.broadcast_to(ks, self.reciprocal_shape)

    def _stacked(self, axes, shape) -> torch.Tensor:
        """The 1-D ``axes`` broadcast over ``shape`` and stacked on a
        trailing axis ((*shape, dim); in 1-D the axis itself)."""
        if self.dim == 1:
            return torch.from_numpy(np.ascontiguousarray(axes[0])).to(self.device)
        grid = np.stack([np.broadcast_to(self._np_align(a, d), shape)
                         for d, a in enumerate(axes)], axis=-1)
        return torch.from_numpy(grid).to(self.device)

    @property
    def x_grid(self) -> torch.Tensor:
        """Cell-centre coordinates, (*shape, dim) for dim > 1 (reference
        DomainAction.C:1457-1477; marlin_tpu/domain.py:x_grid)."""
        return self._stacked(self._np_axes, self.shape)

    @property
    def k_grid(self) -> torch.Tensor:
        """Reciprocal coordinates, (*reciprocal_shape, dim) for dim > 1; under
        PALLAS in the kernels' permuted order, as ``reciprocal_axis``."""
        return self._stacked(self._np_raxes, self.reciprocal_shape)

    def axis(self, d: int) -> torch.Tensor:
        return self.axes[d]

    def reciprocal_axis(self, d: int) -> torch.Tensor:
        if d < self.dim:
            return self.reciprocal_axes[d]
        return torch.zeros([1] * self.dim, dtype=self.dtype, device=self.device)

    # -- transforms --------------------------------------------------------
    def _value_axes_first(self, t: torch.Tensor) -> torch.Tensor:
        """A field's trailing value axes moved in front of its spatial
        axes (no copy for a scalar field)."""
        if t.ndim < self.dim:
            raise ValueError(
                f"fft_backend = PALLAS: a rank-{t.ndim} tensor has fewer axes "
                f"than the {self.dim}-D grid")
        nv = t.ndim - self.dim
        return t.movedim(tuple(range(self.dim, t.ndim)), tuple(range(nv))) if nv else t

    def _value_axes_last(self, u: torch.Tensor) -> torch.Tensor:
        nv = u.ndim - self.dim
        return u.movedim(tuple(range(nv)), tuple(range(self.dim, u.ndim))) if nv else u

    def _check_spectral(self, what: str):
        if self.parallel_mode == "REAL_SPACE":
            raise RuntimeError(f"{what} is not available in REAL_SPACE parallel mode.")

    def _check_slab_scalar(self, t: torch.Tensor):
        if self.mesh is not None and self.fft_backend == "PALLAS" and t.ndim != self.dim:
            raise RuntimeError(
                "fft_backend = PALLAS supports scalar fields only in "
                f"FFT_SLAB mode (got a rank-{t.ndim} tensor on a "
                f"{self.dim}-D grid)"
            )

    def fft(self, t: torch.Tensor) -> torch.Tensor:
        """Forward FFT over the spatial axes (reference fftSerial :853-867;
        the slab transforms of ``parallel`` on a mesh); trailing value dims
        pass through."""
        self._check_spectral("FFT")
        if self.mesh is not None:
            self._check_slab_scalar(t)
            return parallel.fft(self, t)
        tb = self._value_axes_first(t)
        dims = tuple(range(tb.ndim - self.dim, tb.ndim))
        if self.fft_backend == "PALLAS":
            x = tb.to(torch.complex64 if t.is_complex() else torch.float32)
            return self._value_axes_last(unordered_fft.fwd_axes(x, dims)).to(self.cdtype)
        if tb is not t:
            # each field a contiguous block: the bits it has alone
            tb = tb.contiguous()
        half = self.half_axis
        if t.is_complex() or half is None:
            # a complex field, or the full spectrum of 2-D FFT_SLAB run
            # without a mesh (marlin_tpu/domain.py:453-465)
            return self._value_axes_last(torch.fft.fftn(tb, dim=dims)).to(self.cdtype)
        if half != self.dim - 1:
            # rfftn halves the last axis it is given: a pencil's x goes last
            # (rfftn(axes=(1, 2, 0)), marlin_tpu/domain.py:462-464)
            dims = tuple(a for a in dims if a != dims[half]) + (dims[half],)
        return self._value_axes_last(torch.fft.rfftn(tb, dim=dims)).to(self.cdtype)

    def fft_spec(self, shape, dtype):
        """(shape, dtype, layout) that ``fft`` gives a tensor of this shape
        and dtype (the layout as ``parallel.layout_spec`` reads it)."""
        shape = tuple(shape)
        if dtype.is_complex and self.fft_backend == "DEFAULT":
            # fftn keeps the full spectrum
            full = tuple(s.stop - s.start for s in self.full_slice)
            return full + shape[self.dim:], self.cdtype, parallel.FULL
        return self.reciprocal_shape + shape[self.dim:], self.cdtype, parallel.RECIPROCAL

    def ifft_spec(self, shape, dtype):
        """(shape, dtype, layout) that ``ifft`` gives a tensor of this shape
        and dtype."""
        return self.shape + tuple(shape)[self.dim:], self.dtype, parallel.REAL

    def ifft(self, t: torch.Tensor) -> torch.Tensor:
        """Inverse FFT, divided by the cell count.  A division, not torch's
        product with the rounded 1/N: float32(1/N) is off by a fixed
        relative amount where N is not a power of two (-2.5e-8 at 200²),
        which would scale the field's mean at every inverse, and a solver
        that transforms back and forth each substep would drift its mass
        (the kernels' InvStore divides for the same reason)."""
        self._check_spectral("IFFT")
        if self.mesh is not None:
            self._check_slab_scalar(t)
            return parallel.ifft(self, t)
        spatial = tuple(range(self.dim))
        if self.fft_backend == "PALLAS":
            tb = self._value_axes_first(t)
            shape = tuple(tb.shape[:tb.ndim - self.dim]) + self.shape
            u = unordered_fft.inv_axes(tb.reshape(shape),
                                       range(tb.ndim - self.dim, tb.ndim),
                                       real_output=True)
            return self._value_axes_last(u).to(self.dtype)
        half = self.half_axis
        # a full spectrum (forward transform of a complex field, or any of
        # 2-D FFT_SLAB run without a mesh) would be cropped by irfftn; see
        # marlin_tpu/domain.py:ifft for the n <= 2 degeneracy this shape
        # test shares
        if (half is None
                or (t.shape[half] != self.reciprocal_shape[half]
                    and t.shape[half] == self.shape[half])):
            u = torch.fft.ifftn(t, dim=spatial, norm="forward").real
        elif half == self.dim - 1:
            u = torch.fft.irfftn(t, s=self.shape, dim=spatial, norm="forward")
        else:
            dims = tuple(a for a in spatial if a != half) + (half,)
            u = torch.fft.irfftn(t, s=[self.shape[a] for a in dims], dim=dims,
                                 norm="forward")
        return (u / self._cells(u.dtype)).to(self.dtype)

    # -- reductions --------------------------------------------------------
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the spatial axes; trailing value axes stay
        (marlin_tpu/domain.py:sum); over the whole mesh on a mesh."""
        return self.reduce(t.sum(dim=tuple(range(self.dim))))

    def average(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum(t) / self.n_cells_global

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` (a rank's partial result) reduced over the mesh: sum, max,
        min or nanmax (``parallel.all_reduce``); ``t`` itself without a
        mesh."""
        return parallel.all_reduce(self.mesh, t, op)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole grid's field from every rank's real-space block
        (trailing value axes kept); ``t`` itself without a mesh."""
        if self.mesh is None:
            return t
        shape = tuple(self.n_global) + tuple(t.shape[self.dim:])
        return parallel._gather(self.mesh, t, parallel.real_spec(self, t.ndim), shape)

    def gather_to(self, t: torch.Tensor, root: int = 0) -> Optional[torch.Tensor]:
        """The whole grid's field from every rank's real-space block, on
        the host of rank ``root`` (None on the others; ``parallel.gather_to``:
        no other rank holds the whole field); ``t`` on the host without a
        mesh.  Every rank calls it."""
        if self.mesh is None:
            return t.detach().cpu()
        shape = tuple(self.n_global)
        return parallel.gather_to(self.mesh, t.detach(), parallel.real_spec(self, t.ndim),
                                  shape, root, device="cpu")

    def numel(self, t: torch.Tensor) -> int:
        """The element count of a field over the whole mesh (``t.numel()``
        without one): from the block's shape where it is a real- or
        reciprocal-space block, else by a reduction."""
        if self.mesh is None:
            return t.numel()
        head = tuple(t.shape[:self.dim])
        for local, whole in ((self.shape, self.n_global),
                             (self.reciprocal_shape, self.global_reciprocal_shape)):
            # from the whole grid's extents, so that a rank's empty block
            # counts as the others do, with no collective of its own
            if head == local:
                return math.prod(whole) * math.prod(t.shape[self.dim:])
        return int(parallel.all_reduce(
            self.mesh, torch.tensor(float(t.numel()), dtype=torch.float64,
                                    device=self.device)).item())

    def spectrum(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a half spectrum without a pencil's pad rows
        (rows of k = 0 past the half extent, zero after every forward
        transform): what a reduction over the spectrum may read.  ``t``
        itself where there is no pad or ``t`` is a full spectrum."""
        if (not self.reciprocal_pad or not t.is_complex()
                or t.shape[0] != self.reciprocal_shape[0]):
            return t
        rows = self.reciprocal_slice[0]
        valid = self.n_global[0] // 2 + 1
        return t.narrow(0, 0, max(0, min(rows.stop, valid) - rows.start))

    # -- REAL_SPACE halos ----------------------------------------------------
    def halo_dims(self) -> Tuple[int, ...]:
        """The spatial axes that the mesh cuts in real space: the first
        ``len(mesh.shape)`` under REAL_SPACE, y on a slab, y and z on a
        pencil (none without a mesh)."""
        if self.mesh is None:
            return ()
        spec = parallel.real_spec(self, self.dim)
        return tuple(d for d in range(self.dim) if spec[d] is not None)

    def padded(self, t: torch.Tensor, lead: int = 0, width: int = 1) -> torch.Tensor:
        """``t`` (``lead`` axes before its spatial ones) with ``width``
        planes of its neighbours' on each side of every cut axis (the
        periodic wrap where the neighbour is this rank; ``parallel.halo_pad``,
        one exchange a cut axis)."""
        dims = self.halo_dims()
        if not dims:
            return t
        spec = parallel.real_spec(self, self.dim)
        cuts = [(d, self.mesh.axis_names.index(spec[d])) for d in dims]
        return parallel.halo_pad(self.mesh, t, lead, cuts, width)

    def holds_face(self, axis: int, side: int) -> bool:
        """True when this rank's block holds the grid's face on ``axis``
        (side 0 low, 1 high)."""
        sl = self.real_slice[axis]
        return sl.start == 0 if side == 0 else sl.stop == self.n_global[axis]

    def _cells(self, dtype: torch.dtype) -> torch.Tensor:
        """N = prod(n) as a 0-d tensor on the device: dividing by a host
        number would become a product with its reciprocal on the card."""
        if dtype not in self._cells_t:
            self._cells_t[dtype] = torch.tensor(float(self.n_cells_global),
                                                dtype=dtype, device=self.device)
        return self._cells_t[dtype]

    def __repr__(self):
        return (
            f"Domain(dim={self.dim}, n={self.n_global}, "
            f"box={list(zip(self.mins, self.maxs))}, device={self.device}, "
            f"mode={self.parallel_mode}, fft_backend={self.fft_backend})"
        )
