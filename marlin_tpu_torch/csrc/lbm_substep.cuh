// The pieces of kernel 7 (csrc/lbm_substep.cu): the plan in constant memory,
// the velocity sets, and the per-cell stream, face, moment and collision
// steps that the flat, the brick and the plane kernels share (and that
// lbm_probe.cu builds its stripped variants from).  The design notes are at
// the head of lbm_substep.cu.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define LBM_MAX_Q 27
#define LBM_MAX_FACES 8
#define LBM_MAX_POST 8


struct LbmPost {
  int32_t kind;  // 0: Zou-He fixed-order, 1: zero-gradient
  int32_t axis, side;
  uint32_t sum1, sum2, rows;  // direction bitmasks
  int32_t tp, tm;             // the D2Q9 transverse pair, or -1
  int32_t perturb;            // m = avec[perturb][y] * facesum + b, or -1
  double a, b;                // m = a * facesum + b
  double cm[LBM_MAX_Q];       // f[d] = f[op[d]] + cm[d] * m for d in rows
  double tc[LBM_MAX_Q];       //        + tc[d] * (f[tp] - f[tm]) where != 0
};

// One lattice's boundary conditions.
struct LbmFaces {
  int32_t n_faces;
  int32_t face_axis[LBM_MAX_FACES];  // -1: obstacle (wall) bounce-back
  int32_t face_side[LBM_MAX_FACES];
  uint32_t face_dirs[LBM_MAX_FACES];  // replaced directions, bitmask
  int32_t n_post;
  LbmPost post[LBM_MAX_POST];
};

// The coefficients, once in double and once rounded to float.
template <typename T>
struct LbmCoef {
  T w[LBM_MAX_Q];
  T inv_tau[2];  // per lattice
  T bf[3];       // body force
  T inv_cs2, inv_cs4;
  T g, g_rho0, t0;              // gravity, gravity * rho0, T0 (ForceSpec)
  T cs2;                        // c_s^2 of the Smagorinsky flux
  T smag_eta, smag_eta2;        // Smagorinsky: tau0 / t_sgs, its square,
  T smag_inv_2tsgs, smag_c;     // 1 / (2 t_sgs), C_s / c_s^2
  T smag_tau0;
  T guo[LBM_MAX_Q];             // (1 - 0.5 / tau) * w_i / cs^2
  T hpref[LBM_MAX_Q];           // Hermite projection: w_i / (2 cs^2)
  T h2[LBM_MAX_Q * 9];          // Hermite projection: e e / cs^2 - I
  T msm[2][LBM_MAX_Q * LBM_MAX_Q];  // MRT: M^-1 S' M per lattice, q x q
};

// A block of a REAL_SPACE mesh (lbm_fused.FusedLBMConfig.sharded; the
// sharded branch of marlin_tpu/pallas_lbm.py:224 _make_kernel): a pull that
// leaves the block along x (and on a 2-D mesh along y) reads the ring of
// halos the neighbours sent (parallel.halo_ring) in place of the periodic
// wrap, and faces are found on the grid's coordinates.  Unsharded plans
// carry on = 0, offsets 0 and the block's own extents, so on_face reads
// the same fields on every plan.
struct LbmHalo {
  int32_t on;       // 1: a block of a mesh, halos from the rings
  int32_t shard_y;  // 1: a 2-D mesh (y rows and their corners in the ring)
  int64_t xoff, yoff;  // the block's first cell in the grid
  int64_t gnx, gny;    // the grid's x and y extents
  int64_t stride;      // a direction's values in a ring (parallel.ring_size)
};

// The brick walk of a 3-D plan (lbm_fused.brick_plan: by > 0), the
// cooperative launch of a 2-D Smagorinsky plan (lbm_fused.plane_plan: by =
// 0, grid > 0), or neither: the flat kernel.
struct LbmBrick {
  int32_t by;       // rows of y a brick
  int32_t stages;   // bricks in flight a block
  int32_t threads;  // threads a block
  int32_t smem;     // dynamic shared memory a block, bytes (brick_layout)
  int32_t grid;     // the plane kernel's blocks, every one resident
};

struct LbmPlan {
  int64_t nx, ny, nz;
  int32_t two_lattice;
  int32_t collide;   // 0: the collisionless chain
  int32_t speed;     // the carried scalar: 0 zeros, 1 |u|, 2 T
  int32_t force;     // 1: a force field (ForceSpec)
  int32_t gravity, buoyancy, force_dir;
  int32_t guo;       // 1: the Guo source on lattice 1
  int32_t mrt[2], proj[2];
  int32_t bf_on[3];  // non-zero body force component
  int32_t two_d;     // 1: no z velocity component
  int32_t smag;      // 1: the Smagorinsky collision on lattice 1
  LbmHalo halo;
  LbmBrick brick;
  LbmFaces lat[2];
  LbmCoef<double> d;
  LbmCoef<float> f;
};

static_assert(sizeof(LbmPlan) < 65536, "the plan must fit constant memory");

__constant__ LbmPlan c_plan;

template <typename T>
__device__ __forceinline__ const LbmCoef<T>& coef();
template <>
__device__ __forceinline__ const LbmCoef<double>& coef<double>() { return c_plan.d; }
template <>
__device__ __forceinline__ const LbmCoef<float>& coef<float>() { return c_plan.f; }

// The velocity set of stencil Q: constexpr functions, so that a direction
// index folds to a constant once the direction loops unroll.
template <int Q>
struct Lattice;

// marlin_tpu_torch/stencils.py LBMD2Q9
template <>
struct Lattice<9> {
  __host__ __device__ static constexpr int ex(int q) {
    constexpr int t[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
    return t[q];
  }
  __host__ __device__ static constexpr int ey(int q) {
    constexpr int t[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
    return t[q];
  }
  __host__ __device__ static constexpr int ez(int) { return 0; }
  __host__ __device__ static constexpr int op(int q) {
    constexpr int t[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
    return t[q];
  }
};

// marlin_tpu_torch/stencils.py LBMD3Q19
template <>
struct Lattice<19> {
  __host__ __device__ static constexpr int ex(int q) {
    constexpr int t[19] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1};
    return t[q];
  }
  __host__ __device__ static constexpr int ey(int q) {
    constexpr int t[19] = {0, 0, 0, 1, -1, 0, 0, 1, 1, -1, -1, 0, 0, 0, 0, 1, -1, 1, -1};
    return t[q];
  }
  __host__ __device__ static constexpr int ez(int q) {
    constexpr int t[19] = {0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0, 0, 0, 0};
    return t[q];
  }
  __host__ __device__ static constexpr int op(int q) {
    constexpr int t[19] = {0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7, 14, 13, 12, 11, 18, 17, 16, 15};
    return t[q];
  }
};

// marlin_tpu_torch/stencils.py LBMD3Q27
template <>
struct Lattice<27> {
  __host__ __device__ static constexpr int ex(int q) {
    constexpr int t[27] = {0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1,
                           -1, 0, 0, 0, 0, 1, 1, 1, 1, -1, -1, -1, -1};
    return t[q];
  }
  __host__ __device__ static constexpr int ey(int q) {
    constexpr int t[27] = {0, 0, 0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 0, 0,
                           0, 1, 1, -1, -1, 1, -1, -1, 1, 1, -1, -1, 1};
    return t[q];
  }
  __host__ __device__ static constexpr int ez(int q) {
    constexpr int t[27] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, 1,
                           -1, 1, -1, 1, -1, 1, 1, -1, -1, 1, 1, -1, -1};
    return t[q];
  }
  __host__ __device__ static constexpr int op(int q) {
    constexpr int t[27] = {0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7, 14, 13, 12,
                           11, 18, 17, 16, 15, 25, 26, 23, 24, 21, 22, 19, 20};
    return t[q];
  }
};

// The e_x + 1 (axis 0) or e_y + 1 (axis 1) of every direction of stencil
// Q, two bits a direction: for a loop over directions that is not
// unrolled (the halo brick's producer).
template <int Q>
__host__ __device__ constexpr unsigned long long e_bits(int axis) {
  unsigned long long b = 0;
  for (int q = 0; q < Q; ++q)
    b |= (unsigned long long)((axis == 0 ? Lattice<Q>::ex(q) : Lattice<Q>::ey(q)) + 1) << (2 * q);
  return b;
}

namespace {

struct Cell {
  int x, y, z;
};

__device__ __forceinline__ int cell_index(const LbmPlan& p, Cell c) {
  return (c.x * (int)p.ny + c.y) * (int)p.nz + c.z;
}

// A face of the grid: with GRID on the grid's coordinates (the block's
// offset added; the flat kernel and the halo brick, which blocks of a mesh
// take), else on the block's own (the unsharded brick and the plane
// kernel keep the code they had before the halo branch).
template <bool GRID = true>
__device__ __forceinline__ bool on_face(const LbmPlan& p, int axis, int side, Cell c) {
  if (GRID) {
    const int v = axis == 0 ? c.x + (int)p.halo.xoff : (axis == 1 ? c.y + (int)p.halo.yoff : c.z);
    const int n = (int)(axis == 0 ? p.halo.gnx : (axis == 1 ? p.halo.gny : p.nz));
    return v == (side == 0 ? 0 : n - 1);
  }
  const int v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
  const int n = (int)(axis == 0 ? p.nx : (axis == 1 ? p.ny : p.nz));
  return v == (side == 0 ? 0 : n - 1);
}

// The pull source of direction e at cell c of a block of a mesh: an index
// into the block, or (ring) into a direction's ring, laid out as
// parallel.halo_ring packs it: the x-lo and x-hi planes (ny nz each), then
// on a 2-D mesh the y-lo and y-hi rows (nx nz each) and the corner columns
// x-lo/y-lo, x-lo/y-hi, x-hi/y-lo, x-hi/y-hi (nz each).  z wraps in the
// block; y wraps on a 1-D mesh.
struct HaloSrc {
  int i;
  bool ring;
};

__device__ __forceinline__ HaloSrc halo_source(const LbmPlan& p, Cell c, int ex, int ey,
                                               int ez) {
  const int nx = (int)p.nx, ny = (int)p.ny, nz = (int)p.nz;
  int sx = c.x - ex, sy = c.y - ey, sz = c.z - ez;
  sz = sz < 0 ? nz - 1 : (sz == nz ? 0 : sz);
  const bool xo = sx < 0 || sx == nx;
  bool yo = sy < 0 || sy == ny;
  if (yo && !p.halo.shard_y) {
    sy = sy < 0 ? ny - 1 : 0;
    yo = false;
  }
  if (!xo && !yo) return {(sx * ny + sy) * nz + sz, false};
  if (!yo) return {((sx < 0 ? 0 : 1) * ny + sy) * nz + sz, true};
  const int rows = 2 * ny * nz;
  if (!xo) return {rows + ((sy < 0 ? 0 : 1) * nx + sx) * nz + sz, true};
  return {rows + 2 * nx * nz + ((sx < 0 ? 0 : 2) + (sy < 0 ? 0 : 1)) * nz + sz, true};
}

// Plane sx in -1..nx of a block of a mesh, as the halo brick's producer
// reads it, each row (every z) at a multiple of nz: rows 0..ny-1 at at +
// sy nz, in the block or (ring) in the ring's x-lo or x-hi plane; rows -1
// and ny at lo and hi, which on a 1-D mesh wrap in the plane and on a 2-D
// mesh are the ring's y-lo and y-hi rows (a plane in the block) or its
// corner columns (a ring plane).  halo_source's tests and layout at z = 0;
// lbm_fused.brick_rows and media_rows mirror them.  The producer forms
// the three planes of a brick once and each row from them (plane_row).
struct HaloPlane {
  int at, lo, hi;
  bool ring, yring;
};

__device__ __forceinline__ HaloPlane halo_plane(const LbmPlan& p, int sx) {
  const int nx = (int)p.nx, ny = (int)p.ny, nz = (int)p.nz;
  HaloPlane pl;
  pl.ring = sx < 0 || sx == nx;
  pl.at = pl.ring ? (sx < 0 ? 0 : ny * nz) : sx * ny * nz;
  if (!p.halo.shard_y) {
    pl.yring = pl.ring;
    pl.lo = pl.at + (ny - 1) * nz;
    pl.hi = pl.at;
    return pl;
  }
  const int rows = 2 * ny * nz;
  pl.yring = true;
  if (!pl.ring) {
    pl.lo = rows + sx * nz;
    pl.hi = rows + (nx + sx) * nz;
  } else {
    pl.lo = rows + 2 * nx * nz + (sx < 0 ? 0 : 2) * nz;
    pl.hi = pl.lo + nz;
  }
  return pl;
}

__device__ __forceinline__ HaloSrc plane_row(const LbmPlan& p, const HaloPlane& pl, int sy) {
  if ((unsigned)sy < (unsigned)p.ny) return {pl.at + sy * (int)p.nz, pl.ring};
  return {sy < 0 ? pl.lo : pl.hi, pl.yring};
}

// A lattice's ring of halos and the media's, null on unsharded plans.
template <typename T>
struct Ring {
  const T* f;
  const int8_t* m;
};

// i - 1, i, i + 1 around a periodic axis of n: the pull source along an
// axis for e = +1, 0, -1 (the table is indexed by 1 - e)
struct Around {
  int v[3];
  __device__ __forceinline__ Around(int i, int n)
      : v{i == 0 ? n - 1 : i - 1, i, i == n - 1 ? 0 : i + 1} {}
};

// The cell whose state post-stream face k starts from: a zero-gradient
// face cell copies its inner neighbour (torch.roll away from the face).
__device__ __forceinline__ Cell inner(const LbmPlan& p, const LbmPost& bc, Cell c) {
  const int s = bc.side == 1 ? -1 : 1;
  if (bc.axis == 0) c.x = Around(c.x, (int)p.nx).v[1 + s];
  else if (bc.axis == 1) c.y = Around(c.y, (int)p.ny).v[1 + s];
  else c.z = Around(c.z, (int)p.nz).v[1 + s];
  return c;
}

// The cell whose state after face `level` of lattice L becomes this cell's
// final state.
template <bool GRID = true>
__device__ __forceinline__ Cell cell_at_level(const LbmPlan& p, const LbmFaces& L, Cell c,
                                              int level) {
  for (int k = L.n_post; k > level; --k) {
    const LbmPost& bc = L.post[k - 1];
    if (bc.kind == 1 && on_face<GRID>(p, bc.axis, bc.side, c)) c = inner(p, bc, c);
  }
  return c;
}

// Pull stream of every direction of lattice L at cell c, with face and
// obstacle bounce-back from the unstreamed distribution and solid masking.
// Every bounce-back rule, in whatever deck order, writes the same value
// (the opposite direction at the cell), so they reduce to one direction
// mask.
// HALO: the flat kernel's form, faces on the grid's coordinates and the
// rings read on a block of a mesh; the brick and plane kernels take the
// unsharded form (HALO false).
template <int Q, typename T, bool HALO = true>
__device__ __forceinline__ void stream_cell(const LbmPlan& p, const LbmFaces& L,
                                            const T* __restrict__ fpc,
                                            const int8_t* __restrict__ media, long long N,
                                            Cell c, T (&f)[Q], Ring<T> ring = {nullptr, nullptr}) {
  using D = Lattice<Q>;
  const int ny = (int)p.ny, nz = (int)p.nz;
  const Around xs(c.x, (int)p.nx), ys(c.y, ny), zs(c.z, nz);
  const int at = cell_index(p, c);
  const bool solid = media && media[at] == 0;
  const bool fluid = media && media[at] >= 1;
  uint32_t bounce = 0;  // directions replaced by face bounce-back here
  bool wall = false;    // obstacle bounce-back in the plan
  for (int i = 0; i < L.n_faces; ++i) {
    if (L.face_axis[i] < 0) wall = true;
    else if (on_face<HALO>(p, L.face_axis[i], L.face_side[i], c)) bounce |= L.face_dirs[i];
  }
  wall = wall && fluid;
  if (HALO && p.halo.on) {
    // a block of a mesh: the pulls that leave it read the rings
    const long long H = p.halo.stride;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const HaloSrc s = halo_source(p, c, D::ex(q), D::ey(q), D::ez(q));
      T a = s.ring ? ring.f[q * H + s.i] : fpc[q * N + s.i];
      if (((bounce >> q) & 1u) ||
          (q != 0 && wall && (s.ring ? ring.m[s.i] : media[s.i]) == 0))
        a = fpc[D::op(q) * N + at];
      f[q] = solid ? T(0) : a;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int src = (xs.v[1 - D::ex(q)] * ny + ys.v[1 - D::ey(q)]) * nz + zs.v[1 - D::ez(q)];
    T a = fpc[q * N + src];
    if (((bounce >> q) & 1u) || (q != 0 && wall && media[src] == 0))
      a = fpc[D::op(q) * N + at];
    f[q] = solid ? T(0) : a;
  }
}

// The streamed distribution of lattice L at cell c after its post-stream
// faces, in deck order.
template <int Q, typename T, bool HALO = true>
__device__ __forceinline__ void load_lattice(const LbmPlan& p, const LbmFaces& L,
                                             const T* __restrict__ fpc,
                                             const int8_t* __restrict__ media,
                                             const T* __restrict__ avec, long long N,
                                             Cell c, T (&f)[Q], Ring<T> ring = {nullptr, nullptr}) {
  using D = Lattice<Q>;
  bool on_post = false;
  for (int k = 0; k < L.n_post; ++k)
    on_post |= on_face<HALO>(p, L.post[k].axis, L.post[k].side, c);
  stream_cell<Q, T, HALO>(p, L, fpc, media, N,
                          on_post ? cell_at_level<HALO>(p, L, c, 0) : c, f, ring);
  for (int k = 1; on_post && k <= L.n_post; ++k) {
    const LbmPost& bc = L.post[k - 1];
    const Cell ck = cell_at_level<HALO>(p, L, c, k);
    if (!on_face<HALO>(p, bc.axis, bc.side, ck)) continue;
    const bool solid_k = media && media[cell_index(p, ck)] == 0;
    if (bc.kind == 1) {
      // f already holds the inner neighbour's state after face k - 1
      if (solid_k) {
#pragma unroll
        for (int q = 0; q < Q; ++q) f[q] = T(0);
      }
      continue;
    }
    // Zou-He: every read sees the state before this face
    T fsum = T(0);
    bool first = true;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if ((bc.sum1 >> q) & 1u) {
        fsum = first ? f[q] : fsum + f[q];
        first = false;
      }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if ((bc.sum2 >> q) & 1u) fsum = fsum + T(2) * f[q];
    // lbm_fused.apply_zouhe; the perturbed inlet's a(y) by row
    const T a = bc.perturb < 0 ? T(bc.a)
                : HALO ? avec[bc.perturb * p.halo.gny + ck.y + p.halo.yoff]
                       : avec[bc.perturb * p.ny + ck.y];
    const T m = a * fsum + T(bc.b);
    T g[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) g[q] = f[q];
    // the D2Q9 transverse difference, read by static index
    T gp = T(0), gm = T(0);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q == bc.tp) gp = g[q];
      if (q == bc.tm) gm = g[q];
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if ((bc.rows >> q) & 1u) {
        T v = g[D::op(q)] + T(bc.cm[q]) * m;
        if (bc.tc[q] != 0.0) v = v + T(bc.tc[q]) * (gp - gm);
        f[q] = solid_k ? T(0) : v;
      }
  }
}

// sign(c)·a, with c in {-1, 1}
template <typename T>
__device__ __forceinline__ T signed_term(int c, T a) {
  return c > 0 ? a : -a;
}

// e_q·v over the non-zero components of e_q, in axis order; `none` when
// e_q = 0 (the rest direction)
template <int Q, typename T>
__device__ __forceinline__ T e_dot(int q, T vx, T vy, T vz, bool& none) {
  using D = Lattice<Q>;
  T acc = T(0);
  none = true;
  if (D::ex(q)) { acc = signed_term(D::ex(q), vx); none = false; }
  if (D::ey(q)) { const T t = signed_term(D::ey(q), vy); acc = none ? t : acc + t; none = false; }
  if (D::ez(q)) { const T t = signed_term(D::ez(q), vz); acc = none ? t : acc + t; none = false; }
  return acc;
}

// feq of direction q (reference LBMEquilibrium.C:42-66) for the bulk
// `dens` (rho for f, T for g) at velocity u; third = u²/(2 cs²)
template <int Q, typename T>
__device__ __forceinline__ T equilibrium(int q, T dens, T ux, T uy, T uz, T third) {
  const LbmCoef<T>& k = coef<T>();
  bool rest;
  const T edotu = e_dot<Q, T>(q, ux, uy, uz, rest);
  if (rest) return k.w[q] * dens * (T(1) - third);
  const T second = edotu * k.inv_cs2 + T(0.5) * edotu * edotu * k.inv_cs4;
  return k.w[q] * dens * (T(1) + second - third);
}

// The Hermite projection of the non-equilibrium parts, in place:
// cc_j = Σ_i ccr_ij fneq_i, fneq_i = pref_i Σ_j H2_ij cc_j
// (computes/lbm.py hermite), zero coefficients skipped.
template <int Q, typename T>
__device__ __forceinline__ void hermite(T (&f)[Q]) {
  using D = Lattice<Q>;
  const LbmCoef<T>& k = coef<T>();
  T cc[9];
  bool has[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    has[j] = false;
    cc[j] = T(0);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int a = j / 3, b = j % 3;
      const int ea = a == 0 ? D::ex(i) : (a == 1 ? D::ey(i) : D::ez(i));
      const int eb = b == 0 ? D::ex(i) : (b == 1 ? D::ey(i) : D::ez(i));
      if (ea * eb != 0) {
        const T t = f[i] * T(ea * eb);
        cc[j] = has[j] ? cc[j] + t : t;
        has[j] = true;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    T acc = T(0);
    bool any = false;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const T h = k.h2[i * 9 + j];
      if (h != T(0) && has[j]) {
        const T t = cc[j] * h;
        acc = any ? acc + t : t;
        any = true;
      }
    }
    f[i] = any ? k.hpref[i] * acc : T(0);
  }
}

// The Smagorinsky 1/τ of a cell from its non-equilibrium parts and the
// grid's mean density (computes/lbm.py smagorinsky_inv_tau): the momentum
// flux components (k, x, y) for k = 0 (the reference's nz = 1 quirk, ez2 =
// [1, 0, ez]) and k = 2, each a signed sum in index order, the components
// whose coefficients are all zero left out.
template <int Q, typename T>
__device__ __forceinline__ T smag_inv_tau(const LbmPlan& p, const T (&f)[Q], T mean) {
  using D = Lattice<Q>;
  const LbmCoef<T>& k = coef<T>();
  T q2 = T(0);
  bool any = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r == 0 && p.nz != 1) continue;
    T comp = T(0);
    bool has = false;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int c = D::ex(i) * D::ey(i) * (r == 0 ? 1 : D::ez(i));
      if (c) {
        const T t = signed_term(c, f[i]);
        comp = has ? comp + t : t;
        has = true;
      }
    }
    if (has) {
      const T t = comp * comp;
      q2 = any ? q2 + t : t;
      any = true;
    }
  }
  const T q_mean = sqrt(q2) / (mean * k.cs2);
  const T s = (sqrt(k.smag_eta2 + T(4) * q_mean) - k.smag_eta) * k.smag_inv_2tsgs;
  return T(1) / (k.smag_tau0 + k.smag_c * s);
}

// Sixteen bytes of T, the widest shared-memory load.
template <typename T>
struct Wide;
template <>
struct Wide<float> {
  using type = float4;
};
template <>
struct Wide<double> {
  using type = double2;
};
template <typename T>
constexpr int kWide = 16 / sizeof(T);

// Σ_j f[j] row[j] in index order.  A row of stride Q is read entry by
// entry (constant memory); a padded row (STRIDE a multiple of kWide<T>,
// 16-byte aligned, in shared memory) sixteen bytes at a time, so that one
// load serves four (float) or two (double) of its products.
template <int Q, typename T, int STRIDE>
__device__ __forceinline__ T mrt_row(const T (&f)[Q], const T* row) {
  if constexpr (STRIDE == Q) {
    T relax = f[0] * row[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) relax = relax + f[j] * row[j];
    return relax;
  } else {
    static_assert(STRIDE % kWide<T> == 0 && STRIDE >= Q, "a padded row");
    constexpr int V = kWide<T>;
    const auto* wide = reinterpret_cast<const typename Wide<T>::type*>(row);
    T relax = T(0);
#pragma unroll
    for (int c = 0; c < STRIDE / V; ++c) {
      const typename Wide<T>::type w = wide[c];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = c * V + v;
        if (j < Q) relax = j == 0 ? f[0] * e[v] : relax + f[j] * e[v];
      }
    }
    return relax;
  }
}

// Equilibrium and collision of lattice L (reference LBMBGKCollision /
// LBMMRTCollision / LBMSmagorinskyCollision, with the Hermite projection
// first where the plan asks for it), the Guo source where `guo` (reference
// LBMApplyForces), solid masking, written to out.  L is a constant where
// the caller names the lattice (every coefficient's constant-memory
// address is then static) and runs on a loop over both in the brick
// kernel, which so holds one copy of this code; `msm` is lattice L's MRT
// matrix (M^-1 S' M, q x q), in constant memory (the flat kernel) or
// copied to shared memory (the brick kernel).  FEQ (the final form): each
// direction's equilibrium also goes to feq_out, q-major, zero at solids
// (LBMEquilibrium's masked_fill_solids).
template <int Q, typename T, bool MRT, int STRIDE = Q, bool FEQ = false>
__device__ __forceinline__ void collide(const LbmPlan& p, int L, T (&f)[Q], T dens, T ux, T uy,
                                        T uz, T third, bool solid, bool guo, T rho, T Fx, T Fy,
                                        T Fz, const T* __restrict__ mean, const T* msm,
                                        T* __restrict__ out, long long N, int at,
                                        T* __restrict__ feq_out = nullptr) {
  const LbmCoef<T>& k = coef<T>();
  T inv_tau = k.inv_tau[L];
  const bool mrt = MRT && p.mrt[L];
  const bool smag = L == 0 && p.smag;
  const bool dense = mrt || p.proj[L] || smag;
  if (dense) {
    // every direction's non-equilibrium part at once, in place
#pragma unroll
    for (int q = 0; q < Q; ++q) f[q] = f[q] - equilibrium<Q, T>(q, dens, ux, uy, uz, third);
    if (p.proj[L]) hermite<Q, T>(f);
    if (smag) inv_tau = smag_inv_tau<Q, T>(p, f, *mean);
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const T feq = equilibrium<Q, T>(i, dens, ux, uy, uz, third);
    if constexpr (FEQ) feq_out[i * N + at] = solid ? T(0) : feq;
    T u;
    if (!dense) {
      const T fneq = f[i] - feq;
      u = feq + fneq - fneq * inv_tau;
    } else if (!mrt) {
      u = feq + f[i] - f[i] * inv_tau;
    } else {
      u = feq + f[i];
      if constexpr (MRT) {
        // row i of MSM·fneq over every entry in index order
        // (computes/lbm.py mrt_relax)
        u = u - mrt_row<Q, T, STRIDE>(f, msm + i * STRIDE);
      }
    }
    if (guo) {
      bool rest;
      const T edotf = e_dot<Q, T>(i, Fx, Fy, Fz, rest);
      if (!rest) u = u + k.guo[i] * rho * edotf;
    }
    out[i * N + at] = solid ? T(0) : u;
  }
}

// The cell of this thread: x and y from the grid and z along the block,
// or on a flat (2-D) launch the flattened index (x, y, z) in order.
__device__ __forceinline__ bool thread_cell(const LbmPlan& p, bool flat, Cell& c) {
  if (!flat) {
    c = {(int)blockIdx.z, (int)blockIdx.y, (int)(blockIdx.x * blockDim.x + threadIdx.x)};
    return c.z < p.nz;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.nx * p.ny * p.nz) return false;
  const int nz = (int)p.nz, ny = (int)p.ny;
  c = {(int)(i / ((long long)ny * nz)), (int)((i / nz) % ny), (int)(i % nz)};
  return true;
}


// The moments of the streamed f (reference LBMComputeDensity /
// LBMComputeVelocity), the force field along force_dir, zero at solids
// (LBMComputeForces, from the thermal lattice's T), and the velocity u =
// m / rho (+ F / (2 rho)) (+ body force / (2 rho) where non-zero), zero at
// solids (rho = 0 there), with the eager chain's operations: every
// product, sum and quotient below is one rounding of that chain.
template <typename T>
struct Flow {
  T rho, ux, uy, uz, usqr, Fx, Fy, Fz;
};

template <int Q, typename T>
__device__ __forceinline__ Flow<T> flow(const LbmPlan& p, const T (&f)[Q], T temp,
                                        bool solid) {
  using D = Lattice<Q>;
  const LbmCoef<T>& k = coef<T>();
  T rho = f[0], mx = T(0), my = T(0), mz = T(0);
  bool fx = true, fy = true, fz = true;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (q > 0) rho = rho + f[q];
    if (D::ex(q)) { const T t = signed_term(D::ex(q), f[q]); mx = fx ? t : mx + t; fx = false; }
    if (D::ey(q)) { const T t = signed_term(D::ey(q), f[q]); my = fy ? t : my + t; fy = false; }
    // 2-D: no z component, whatever the stencil
    if (D::ez(q) && !p.two_d) {
      const T t = signed_term(D::ez(q), f[q]);
      mz = fz ? t : mz + t;
      fz = false;
    }
  }
  Flow<T> o;
  o.rho = rho;
  o.Fx = o.Fy = o.Fz = T(0);
  if (p.force) {
    T fd = T(0);
    if (p.gravity) fd = k.g * rho;
    if (p.buoyancy) {
      const T t = k.g_rho0 * (temp - k.t0);
      fd = p.gravity ? fd + t : t;
    }
    if (solid) fd = T(0);
    if (p.force_dir == 0) o.Fx = fd;
    else if (p.force_dir == 1) o.Fy = fd;
    else o.Fz = fd;
  }
  T ux = mx / rho, uy = my / rho, uz = mz / rho;
  if (p.force) {
    ux = ux + o.Fx / (T(2) * rho);
    uy = uy + o.Fy / (T(2) * rho);
    uz = uz + o.Fz / (T(2) * rho);
  }
  if (p.bf_on[0]) ux = ux + k.bf[0] / (T(2) * rho);
  if (p.bf_on[1]) uy = uy + k.bf[1] / (T(2) * rho);
  if (p.bf_on[2]) uz = uz + k.bf[2] / (T(2) * rho);
  if (solid) ux = uy = uz = T(0);
  o.ux = ux;
  o.uy = uy;
  o.uz = uz;
  o.usqr = ux * ux + uy * uy + uz * uz;
  return o;
}

// The carried scalar of a cell: |u|, T or 0.
template <typename T>
__device__ __forceinline__ T carried(const LbmPlan& p, const Flow<T>& fl, T temp) {
  return p.speed == 1 ? sqrt(fl.usqr) : (p.speed == 2 ? temp : T(0));
}

// What the final form of a one-lattice substep (the last of a step) also
// stores, so that its outputs are the deck's buffers as the eager chain
// leaves them: the streamed distribution after its faces (LBMStream and
// the boundary conditions) and each direction's equilibrium
// (LBMEquilibrium), both q-major; the density (LBMComputeDensity); the
// velocity (LBMComputeVelocity), (nx, ny, nz, 3).  Null in the hot form.
template <typename T>
struct Final {
  T* f;
  T* feq;
  T* rho;
  T* vel;
};

// The final form's stores of a cell but the equilibrium (collide's FEQ),
// zero at solids as the eager chain's masked_fill_solids leaves them.
template <int Q, typename T>
__device__ __forceinline__ void store_final(const Final<T>& fin, const T (&f)[Q],
                                            const Flow<T>& fl, bool solid, long long N, int at) {
#pragma unroll
  for (int q = 0; q < Q; ++q) fin.f[q * N + at] = solid ? T(0) : f[q];
  fin.rho[at] = solid ? T(0) : fl.rho;
  T* u = fin.vel + 3LL * at;
  u[0] = fl.ux;  // flow zeroes a solid cell's velocity
  u[1] = fl.uy;
  u[2] = fl.uz;
}

// -- the brick walk (3-D plans) ---------------------------------------------------
//
// A brick is one x-plane, `by` rows of y and every z.  For each lattice and
// direction q a stage holds the `by` source rows the brick pulls from, at
// (x - e_x, y - e_y), whole; the z shift and its periodic wrap read out of
// the stage.  On media plans the stage also holds the media rows of planes
// x - 1 .. x + 1 and rows y - 1 .. y + by.  Each row comes in by one bulk
// copy (cp.async.bulk, the Tensor Memory Accelerator's 1-D form) completed
// on the stage's mbarrier, so the bytes in flight do not depend on
// registers or occupancy.  On a block of a mesh (the halo brick, HALO) a
// row that leaves the block is a whole row of parallel.halo_ring's ring
// (halo_plane), so only the copy's source changes.

// The byte offsets of one stage and of the block's shared memory:
// stages x [lattice][q][by][nz] of T, then [3][by + 2][nz] media bytes,
// each stage rounded up to 16 bytes; then two mbarriers a stage (full,
// empty); then, on MRT plans, each lattice's q x q MRT matrix.
// lbm_fused.brick_layout computes the same sizes.
struct BrickLayout {
  long long lattice_bytes, media_off, stage_bytes, bar_off, msm_off, smem;
};

__host__ __device__ __forceinline__ BrickLayout brick_layout(int q, int tsize, int lattices,
                                                             bool media, bool mrt, int by,
                                                             int stages, long long nz) {
  BrickLayout l;
  l.lattice_bytes = (long long)q * by * nz * tsize;
  l.media_off = lattices * l.lattice_bytes;
  l.stage_bytes = (l.media_off + (media ? 3LL * (by + 2) * nz : 0) + 15) / 16 * 16;
  l.bar_off = stages * l.stage_bytes;
  l.msm_off = l.bar_off + 16LL * stages;
  const int padded = (q * tsize + 15) / 16 * 16 / tsize;  // a row, in T
  l.smem = l.msm_off + (mrt ? (long long)lattices * q * padded * tsize : 0);
  return l;
}

// The row stride of the block's MRT matrices: q rounded up to 16 bytes.
template <int Q, typename T>
constexpr int kMsmStride = (Q * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);

// The block's copy of each lattice's MRT matrix, [lattice][q][stride],
// each row padded with zeros to 16 bytes: every cell reads all of it, 16
// bytes a load (mrt_row), where the constant cache serves one value a
// read.  Every thread takes part, before brick_pipe's __syncthreads.
template <int Q, typename T, bool TWO>
__device__ __forceinline__ const T* brick_msm(unsigned char* at) {
  constexpr int S = kMsmStride<Q, T>;
  T* m = (T*)at;
  for (int i = threadIdx.x; i < (TWO ? 2 : 1) * Q * S; i += blockDim.x) {
    const int l = i / (Q * S), r = i % (Q * S) / S, c = i % S;
    m[i] = c < Q ? coef<T>().msm[l][r * Q + c] : T(0);
  }
  return m;
}

// The most threads a brick block runs (one producer warp and the consumer
// warps) and the blocks an SM that its registers are held to leave room
// for: one lattice's D3Q19 plans 288 threads (eight consumer warps) in at
// most 72 registers, three blocks an SM; D3Q27 plans 160 threads in 96
// registers, four blocks; two-lattice plans 160 threads in 128 registers,
// three blocks, or with MRT in 168 (they spill at 128), two.  Chosen on
// the card (PERF.md §6), as lbm_fused.brick_plan's threads and stages
// beside them.
template <int Q, bool TWO>
constexpr int kBrickThreads = (TWO || Q == 27) ? 160 : 288;
template <int Q, bool TWO, bool MRT>
constexpr int kBrickBlocks = TWO ? (MRT ? 2 : 3) : (Q == 27 ? 4 : 3);

struct Brick {
  int x, y0, rows;  // plane, first row, rows (by, or fewer at y = ny)
};

__device__ __forceinline__ Brick brick_at(const LbmPlan& p, long long b) {
  const int by = p.brick.by;
  const int nyb = (int)((p.ny + by - 1) / by);
  Brick k;
  k.x = (int)(b / nyb);
  k.y0 = (int)(b % nyb) * by;
  k.rows = min(by, (int)p.ny - k.y0);
  return k;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One row, global to shared, completing on `bar`; 16-byte aligned ends.
__device__ __forceinline__ void bulk_row(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// (i + d) mod n for d in -1..1 and 0 <= i < n
__device__ __forceinline__ int wrap(int i, int d, int n) {
  const int v = i + d;
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The producer warp brings brick b into `stage`: the barrier's expected
// bytes from lane 0, then the rows spread over the lanes.  SHIFT false
// reads each row at the brick's own (x, y) (the probe's copy-only variant).
// HALO (a block of a mesh; one lattice): a row whose source leaves the
// block comes from its row of the lattice's ring (fr.f) or the media's
// (fr.m), the same one bulk copy of the same bytes a row.  The producer's
// code runs beside the consumers' on the SM and is kept small: one loop,
// not unrolled, over this lane's own rows (no test of every row, no
// divide a row), the direction's e from e_bits, a row's source a select
// or a multiply-add from its plane's (halo_plane, three a brick).  On the
// card the unrolled form of this loop (the unsharded brick's) ran a
// porous block at about twice the unsharded brick's time, its Q offsets
// held across bricks and spilled; this loop runs it in less than the
// unsharded brick's time (PERF.md §6, row 7h).
template <int Q, typename T, bool SHIFT, bool HALO = false>
__device__ __forceinline__ void brick_fetch(const LbmPlan& p, long long lattice_bytes,
                                            long long media_off, const T* __restrict__ fpc,
                                            const T* __restrict__ gpc,
                                            const int8_t* __restrict__ media,
                                            unsigned char* stage, uint64_t* bar, Brick b,
                                            Ring<T> fr = {nullptr, nullptr}) {
  using D = Lattice<Q>;
  const int lane = threadIdx.x & 31;
  const int nx = (int)p.nx, ny = (int)p.ny, by = p.brick.by;
  const long long nz = p.nz, N = p.nx * p.ny * p.nz;
  const uint32_t row = (uint32_t)(nz * sizeof(T));
  const int lattices = gpc ? 2 : 1;
  if (lane == 0) {
    // order the consumers' reads of the stage, released to the empty
    // barrier, before the copies that overwrite it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, (uint32_t)(lattices * Q * b.rows * row +
                                   (media ? 3 * (b.rows + 2) * nz : 0)));
  }
  __syncwarp();
  if constexpr (HALO) {
    static_assert(SHIFT, "the halo brick streams");
    constexpr unsigned long long EX = e_bits<Q>(0), EY = e_bits<Q>(1);
    const HaloPlane lo = halo_plane(p, b.x - 1), mid = halo_plane(p, b.x),
                    hi = halo_plane(p, b.x + 1);
    const long long H = p.halo.stride;
    // this lane's rows r = lane, lane + 32, ... of the brick's Q by: q = r
    // / by, j = r mod by, stepped by 32 = dq by + dj
    const int dq = 32 / by, dj = 32 % by;
#pragma unroll 1
    for (int q = lane / by, j = lane % by; q < Q;) {
      if (j < b.rows) {
        const int ex = (int)((EX >> (2 * q)) & 3) - 1, ey = (int)((EY >> (2 * q)) & 3) - 1;
        const HaloSrc s = plane_row(p, ex > 0 ? lo : (ex < 0 ? hi : mid), b.y0 + j - ey);
        bulk_row(stage + (long long)(q * by + j) * row,
                 s.ring ? fr.f + (q * H + s.i) : fpc + (q * N + s.i), row, bar);
      }
      q += dq;
      j += dj;
      if (j >= by) {
        j -= by;
        ++q;
      }
    }
    if (media) {
      // planes x - 1 .. x + 1, rows y0 - 1 .. y0 + rows
      const int m = b.rows + 2;
#pragma unroll 1
      for (int i = lane; i < 3 * m; i += 32) {
        const int dx = (i >= m) + (i >= 2 * m), jj = i - dx * m;
        const HaloSrc s = plane_row(p, dx == 0 ? lo : (dx == 1 ? mid : hi), b.y0 + jj - 1);
        bulk_row(stage + media_off + (long long)(dx * (by + 2) + jj) * nz,
                 (s.ring ? fr.m : media) + s.i, (uint32_t)nz, bar);
      }
    }
    return;
  }
  for (int l = 0; l < lattices; ++l) {
    const T* src = l ? gpc : fpc;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int sx = SHIFT ? wrap(b.x, -D::ex(q), nx) : b.x;
      for (int j = 0; j < b.rows; ++j) {
        if (((l * Q + q) * by + j) % 32 != lane) continue;
        const int sy = SHIFT ? wrap(b.y0 + j, -D::ey(q), ny) : b.y0 + j;
        bulk_row(stage + l * lattice_bytes + (long long)(q * by + j) * row,
                 src + q * N + ((long long)sx * ny + sy) * nz, row, bar);
      }
    }
  }
  if (media) {
    for (int i = lane; i < 3 * (b.rows + 2); i += 32) {
      const int dx = i / (b.rows + 2), jj = i % (b.rows + 2);
      const int sx = wrap(b.x, dx - 1, nx);
      // rows y0 - 1 .. y0 + rows; the last may be past a short brick's end
      const int sy = (b.y0 + jj - 1 + ny) % ny;
      bulk_row(stage + media_off + (long long)(dx * (by + 2) + jj) * nz,
               media + ((long long)sx * ny + sy) * nz, (uint32_t)nz, bar);
    }
  }
}

// The block's brick pipeline.  Block k takes bricks blockIdx.x, +
// gridDim.x, ...; warp 0 produces (brick_produce), the other warps consume
// (brick_acquire, their cells, brick_release).  Stage s of the i-th brick
// (s = i mod stages) is full once its bytes have landed and empty once
// every consumer warp has released it, so a warp held by a global read
// (a bounce-back from the unstreamed value, a face cell) delays no other
// warp until the producer needs its stage again.
struct BrickPipe {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  long long stage_bytes, bricks;
  int stages;
};

// Initialise the barriers (every thread of the block takes part: one
// __syncthreads, the block's only one).
__device__ __forceinline__ BrickPipe brick_pipe(const LbmPlan& p, const BrickLayout& lay,
                                                unsigned char* smem) {
  BrickPipe pipe;
  pipe.smem = smem;
  pipe.stages = p.brick.stages;
  pipe.full = (uint64_t*)(smem + lay.bar_off);
  pipe.empty = pipe.full + pipe.stages;
  pipe.stage_bytes = lay.stage_bytes;
  pipe.bricks = p.nx * ((p.ny + p.brick.by - 1) / p.brick.by);
  if (threadIdx.x == 0) {
    for (int s = 0; s < pipe.stages; ++s) {
      mbar_init(&pipe.full[s], 1);
      mbar_init(&pipe.empty[s], blockDim.x / 32 - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return pipe;
}

template <int Q, typename T, bool SHIFT, bool HALO = false>
__device__ __forceinline__ void brick_produce(const LbmPlan& p, const BrickPipe& pipe,
                                              long long lattice_bytes, long long media_off,
                                              const T* __restrict__ fpc,
                                              const T* __restrict__ gpc,
                                              const int8_t* __restrict__ media,
                                              Ring<T> fr = {nullptr, nullptr}) {
  long long k = 0;
  for (long long b = blockIdx.x; b < pipe.bricks; b += gridDim.x, ++k) {
    const int s = (int)(k % pipe.stages);
    if (k >= pipe.stages) mbar_wait(&pipe.empty[s], (uint32_t)((k / pipe.stages - 1) & 1));
    brick_fetch<Q, T, SHIFT, HALO>(p, lattice_bytes, media_off, fpc, gpc, media,
                                   pipe.smem + s * pipe.stage_bytes, &pipe.full[s],
                                   brick_at(p, b), fr);
  }
}

// The stage of the consumer's k-th brick, once it has landed.
__device__ __forceinline__ unsigned char* brick_acquire(const BrickPipe& pipe,
                                                              long long k) {
  const int s = (int)(k % pipe.stages);
  mbar_wait(&pipe.full[s], (uint32_t)((k / pipe.stages) & 1));
  return pipe.smem + s * pipe.stage_bytes;
}

__device__ __forceinline__ void brick_release(const BrickPipe& pipe, long long k) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&pipe.empty[k % pipe.stages]);
}

// The brick's view of one stage: each lattice's rows [q][by][nz] and the
// media rows [3][by + 2][nz] (or null).  Slot (q, j, (z - e_z) mod nz) of
// a lattice is read by the cell at row j, z and by no other, so the cell
// may write its streamed value back there.
template <typename T>
struct Stage {
  T* lat0;
  T* lat1;
  const int8_t* media;
  int by, nz;
  // direction q's pulled value of the cell at row j, z (its source z already
  // wrapped)
  __device__ __forceinline__ T& row(int l, int q, int j, int zq) const {
    return (l ? lat1 : lat0)[(q * by + j) * nz + zq];
  }
  // the media byte of plane x + dx, row y + dy of the cell at row j
  __device__ __forceinline__ int8_t m(int dx, int j, int dy, int z) const {
    return media[((1 + dx) * (by + 2) + j + 1 + dy) * nz + z];
  }
};

template <typename T>
__device__ __forceinline__ Stage<T> stage_at(unsigned char* s, long long lattice_bytes,
                                             long long media_off, bool two, bool has_media,
                                             int by, int nz) {
  Stage<T> st;
  st.lat0 = (T*)s;
  st.lat1 = two ? (T*)(s + lattice_bytes) : nullptr;
  st.media = has_media ? (const int8_t*)(s + media_off) : nullptr;
  st.by = by;
  st.nz = nz;
  return st;
}

// stream_cell of the cell at row j of the brick, out of the stage: the same
// pull stream, face and obstacle bounce-back (from the unstreamed value at
// the cell, a global read inside the block) and solid masking; HALO: the
// faces on the grid's coordinates.
template <int Q, typename T, bool HALO = false>
__device__ __forceinline__ void brick_stream(const LbmPlan& p, const LbmFaces& L,
                                             Stage<T> st, int l,
                                             const T* __restrict__ fpc, long long N, Cell c,
                                             int j, T (&f)[Q]) {
  using D = Lattice<Q>;
  const Around zs(c.z, (int)p.nz);
  const int at = cell_index(p, c);
  const bool solid = st.media && st.m(0, j, 0, c.z) == 0;
  const bool fluid = st.media && st.m(0, j, 0, c.z) >= 1;
  uint32_t bounce = 0;
  bool wall = false;
  for (int i = 0; i < L.n_faces; ++i) {
    if (L.face_axis[i] < 0) wall = true;
    else if (on_face<HALO>(p, L.face_axis[i], L.face_side[i], c)) bounce |= L.face_dirs[i];
  }
  wall = wall && fluid;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int zq = zs.v[1 - D::ez(q)];
    T a = st.row(l, q, j, zq);
    if (((bounce >> q) & 1u) || (q != 0 && wall && st.m(-D::ex(q), j, -D::ey(q), zq) == 0))
      a = fpc[D::op(q) * N + at];
    f[q] = solid ? T(0) : a;
  }
}

// load_lattice of the brick: a cell on a post-stream face takes the global
// path (its state may start at another cell), every other cell streams
// out of the stage.  HALO: faces on the grid's coordinates, and the
// global path reads the lattice's ring where a pull leaves the block.
template <int Q, typename T, bool HALO = false>
__device__ __forceinline__ void brick_lattice(const LbmPlan& p, const LbmFaces& L,
                                              Stage<T> st, int l,
                                              const T* __restrict__ fpc,
                                              const int8_t* __restrict__ media,
                                              const T* __restrict__ avec, long long N,
                                              Cell c, int j, T (&f)[Q],
                                              Ring<T> ring = {nullptr, nullptr}) {
  bool on_post = false;
  for (int k = 0; k < L.n_post; ++k)
    on_post |= on_face<HALO>(p, L.post[k].axis, L.post[k].side, c);
  if (on_post) {
    if constexpr (HALO) load_lattice<Q, T, true>(p, L, fpc, media, avec, N, c, f, ring);
    else load_lattice<Q, T, false>(p, L, fpc, media, avec, N, c, f);
  } else {
    brick_stream<Q, T, HALO>(p, L, st, l, fpc, N, c, j, f);
  }
}

// The streamed value of every direction of lattice l at the cell (after
// its bounce-back, masking and faces), written back to the cell's own
// slots of the stage.
template <int Q, typename T, bool HALO = false>
__device__ __forceinline__ void settle(const LbmPlan& p, const LbmFaces& L, Stage<T> st, int l,
                                       const T* __restrict__ fpc,
                                       const int8_t* __restrict__ media,
                                       const T* __restrict__ avec, long long N, Cell c, int j,
                                       Ring<T> ring = {nullptr, nullptr}) {
  using D = Lattice<Q>;
  T f[Q];
  brick_lattice<Q, T, HALO>(p, L, st, l, fpc, media, avec, N, c, j, f, ring);
  const Around zs(c.z, (int)p.nz);
#pragma unroll
  for (int q = 0; q < Q; ++q) st.row(l, q, j, zs.v[1 - D::ez(q)]) = f[q];
}

// The settled values of lattice l at the cell, out of its slots.
template <int Q, typename T>
__device__ __forceinline__ void settled(Stage<T> st, int l, int j, int z, T (&f)[Q]) {
  using D = Lattice<Q>;
  const Around zs(z, st.nz);
#pragma unroll
  for (int q = 0; q < Q; ++q) f[q] = st.row(l, q, j, zs.v[1 - D::ez(q)]);
}

// Keeps values from living across it: the compiler must read them again
// after it (from the stage), so at most one lattice is held in registers.
__device__ __forceinline__ void forget() { asm volatile("" ::: "memory"); }

}  // namespace
