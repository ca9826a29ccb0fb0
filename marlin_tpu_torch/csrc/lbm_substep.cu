// One whole lattice Boltzmann substep in one pass: the port of
// marlin_tpu/pallas_lbm.py:224 _make_kernel (called through fused_substep),
// for 3-D D3Q19 and D3Q27 and 2-D D2Q9 chains: BGK or MRT collisions, the
// Hermite projection, the Smagorinsky collision, face bounce-back, a body
// force, binary media (obstacle bounce-back and solid masking), the
// post-stream Zou-He fixed-order faces (with the D2Q9 transverse rows and
// the perturbed inlet's a(y) rows) and zero-gradient faces, the
// collisionless chain, and the thermal double-distribution chain (a second
// lattice g with its own faces, T = Σg, Boussinesq buoyancy and gravity,
// the F/(2ρ) velocity shift and the Guo source on f).
//
//   read  fpc_old (q, nx, ny, nz), pull-streamed, periodic on every axis
//         gpc_old (q, nx, ny, nz) on two-lattice plans
//         media   (nx, ny, nz) int8 code (0 solid, 1 fluid, -1 neither)
//         avec    (n, ny): a(y) of each perturbed Zou-He inlet
//         mean    the grid's mean density (Smagorinsky plans)
//   write fpc_new (q, nx, ny, nz), gpc_new, speed (nx, ny, nz): |u|, T or 0
//
// Bound on an H100 SXM: bytes.  Each cell reads q values and writes q a
// lattice, plus the carried scalar and the media byte (at 256^3 with D3Q19
// in float32: 157 B a cell, 0.79 ms at 3.35 TB/s; two lattices 309 B,
// 1.55 ms).  MRT adds about q^2 multiplies and adds a lattice-cell (no
// contraction: the library is built with -fmad=false), 24 GFLOP a
// two-lattice D3Q19 substep at 256^3, 0.36 ms at 67 TFLOP/s: still under
// the byte bound.  The design follows from that:
//
// * one thread a cell, z the fastest index, so every direction's pull read
//   and every write is coalesced; x and y come from the grid and the
//   periodic neighbours are computed once a cell, so a direction's source
//   address is a few integer adds.  The TPU kernel's x-block pipeline, its
//   VMEM carry of the previous block's last plane and its block choice
//   exist for the TPU's sequential grid and are not carried over;
// * the q streamed values of each lattice stay in registers from the read
//   to the write; the MRT and projected collisions turn them into the
//   non-equilibrium parts in place.  The stencils' e and op tables are
//   compiled in (the template on Q) so that every direction index is
//   static: a run-time index into a register array would send it to local
//   memory.  The wrapper holds the compiled tables to the plan's once
//   (mtt_lbm_tables).  The second lattice and MRT change the set of live
//   registers and the code size, so they are template parameters; the
//   projection, the forces, the collisionless chain and which lattice runs
//   MRT are warp-uniform branches on the plan;
// * the plan (the coefficients, each lattice's bounce-back faces in deck
//   order with -1 for the obstacle slot and its post-stream faces with
//   their Zou-He coefficients) is one struct in constant memory, copied on
//   the launch's stream before it.  Its coefficient tables come in double
//   and in float, each the rounding of the double the eager chain
//   multiplies by, so a float kernel reads its constants without a
//   conversion; constant memory serves a warp that reads one entry at once
//   (every coefficient index below is uniform);
// * every sum runs in the eager chain's order (computes/lbm.py): the MRT
//   rows over every entry and the Hermite sums with their zero
//   coefficients skipped, each over directions in index order, so PALLAS
//   and JNP give the same bits;
// * the post-stream faces run in deck order, each on the state the earlier
//   ones left.  The TPU kernel holds whole planes; a thread holds one cell,
//   so a zero-gradient face cell must start from its inner neighbour's
//   state after the earlier faces.  That dependence is a chain, not a tree
//   (a zero-gradient face replaces every direction), so each thread walks
//   the faces backwards to the cell its state starts from, streams that
//   cell, and replays the faces forwards, for each lattice with its own
//   faces.  Only face cells ever start from another cell;
// * a 2-D plan (nz = 1) takes one thread a cell over the flattened (x, y)
//   grid, y the fastest index: z along the block would leave one live
//   thread in 32.  D2Q9 in float32 is 77 B a cell (36 read, 36 written,
//   the speed and the media byte): 12.3 MB, 3.7 us at 800x200, less than a
//   launch costs, so the shipped 2-D size is launch-bound;
// * the Smagorinsky τ needs the mean density of the whole grid before any
//   cell collides.  Blocks run in no order and atomics add in no fixed
//   order (their bits would change from run to run and differ from the
//   eager chain's), so two more passes come first: lbm_density_kernel
//   streams each cell, applies the faces, sums ρ and reduces each aligned
//   chunk of 256 cells by a pairwise tree; lbm_mean_kernel, one block,
//   finishes the same tree (computes/lbm.py tree_mean) and writes the mean
//   on the device, where the substep kernel reads it: no host sync.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define LBM_MAX_Q 27
#define LBM_MAX_FACES 8
#define LBM_MAX_POST 8

#define LBM_DENSITY_BLOCK 256
#define LBM_MEAN_THREADS 1024

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

namespace {

struct Cell {
  int x, y, z;
};

__device__ __forceinline__ int cell_index(const LbmPlan& p, Cell c) {
  return (c.x * (int)p.ny + c.y) * (int)p.nz + c.z;
}

__device__ __forceinline__ bool on_face(const LbmPlan& p, int axis, int side, Cell c) {
  const int v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
  const int n = (int)(axis == 0 ? p.nx : (axis == 1 ? p.ny : p.nz));
  return v == (side == 0 ? 0 : n - 1);
}

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
__device__ __forceinline__ Cell cell_at_level(const LbmPlan& p, const LbmFaces& L, Cell c,
                                              int level) {
  for (int k = L.n_post; k > level; --k) {
    const LbmPost& bc = L.post[k - 1];
    if (bc.kind == 1 && on_face(p, bc.axis, bc.side, c)) c = inner(p, bc, c);
  }
  return c;
}

// Pull stream of every direction of lattice L at cell c, with face and
// obstacle bounce-back from the unstreamed distribution and solid masking.
// Every bounce-back rule, in whatever deck order, writes the same value
// (the opposite direction at the cell), so they reduce to one direction
// mask.
template <int Q, typename T>
__device__ __forceinline__ void stream_cell(const LbmPlan& p, const LbmFaces& L,
                                            const T* __restrict__ fpc,
                                            const int8_t* __restrict__ media, long long N,
                                            Cell c, T (&f)[Q]) {
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
    else if (on_face(p, L.face_axis[i], L.face_side[i], c)) bounce |= L.face_dirs[i];
  }
  wall = wall && fluid;
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
template <int Q, typename T>
__device__ __forceinline__ void load_lattice(const LbmPlan& p, const LbmFaces& L,
                                             const T* __restrict__ fpc,
                                             const int8_t* __restrict__ media,
                                             const T* __restrict__ avec, long long N,
                                             Cell c, T (&f)[Q]) {
  using D = Lattice<Q>;
  bool on_post = false;
  for (int k = 0; k < L.n_post; ++k) on_post |= on_face(p, L.post[k].axis, L.post[k].side, c);
  stream_cell<Q, T>(p, L, fpc, media, N, on_post ? cell_at_level(p, L, c, 0) : c, f);
  for (int k = 1; on_post && k <= L.n_post; ++k) {
    const LbmPost& bc = L.post[k - 1];
    const Cell ck = cell_at_level(p, L, c, k);
    if (!on_face(p, bc.axis, bc.side, ck)) continue;
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
    const T a = bc.perturb >= 0 ? avec[bc.perturb * p.ny + ck.y] : T(bc.a);
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

// Equilibrium and collision of lattice L (reference LBMBGKCollision /
// LBMMRTCollision / LBMSmagorinskyCollision, with the Hermite projection
// first where the plan asks for it), the Guo source where `guo` (reference
// LBMApplyForces), solid masking, written to out.  L is a template
// parameter so that every coefficient's constant-memory address is static.
template <int Q, typename T, bool MRT, int L>
__device__ __forceinline__ void collide(const LbmPlan& p, T (&f)[Q], T dens, T ux, T uy, T uz,
                                        T third, bool solid, bool guo, T rho, T Fx, T Fy, T Fz,
                                        const T* __restrict__ mean, T* __restrict__ out,
                                        long long N, int at) {
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
        const T* row = k.msm[L] + i * Q;
        T relax = f[0] * row[0];
#pragma unroll
        for (int j = 1; j < Q; ++j) relax = relax + f[j] * row[j];
        u = u - relax;
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

template <int Q, typename T, bool TWO, bool MRT>
__global__ void __launch_bounds__(256)
lbm_substep_kernel(const T* __restrict__ fpc, const T* __restrict__ gpc,
                   const int8_t* __restrict__ media, const T* __restrict__ avec,
                   const T* __restrict__ mean, T* __restrict__ out,
                   T* __restrict__ gout, T* __restrict__ speed, bool flat) {
  using D = Lattice<Q>;
  const LbmPlan& p = c_plan;
  const LbmCoef<T>& k = coef<T>();
  Cell c;
  if (!thread_cell(p, flat, c)) return;
  const long long N = p.nx * p.ny * p.nz;
  const int at = cell_index(p, c);
  const bool solid = media && media[at] == 0;

  T f[Q];
  load_lattice<Q, T>(p, p.lat[0], fpc, media, avec, N, c, f);
  T g[TWO ? Q : 1];
  if constexpr (TWO) load_lattice<Q, T>(p, p.lat[1], gpc, media, avec, N, c, g);

  // moments (reference LBMComputeDensity / LBMComputeVelocity)
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
  // the thermal lattice's zeroth moment (LBMComputeDensity on g)
  T temp = T(0);
  if constexpr (TWO) {
    temp = g[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) temp = temp + g[q];
  }
  // the force field along force_dir, zero at solids (LBMComputeForces)
  T Fx = T(0), Fy = T(0), Fz = T(0);
  if (p.force) {
    T fd = T(0);
    if (p.gravity) fd = k.g * rho;
    if (p.buoyancy) {
      const T t = k.g_rho0 * (temp - k.t0);
      fd = p.gravity ? fd + t : t;
    }
    if (solid) fd = T(0);
    if (p.force_dir == 0) Fx = fd;
    else if (p.force_dir == 1) Fy = fd;
    else Fz = fd;
  }
  // u = m / rho (+ F / (2 rho)) (+ body force / (2 rho) where non-zero),
  // zero at solids (rho = 0 there), with the eager chain's operations:
  // every product, sum and quotient below is one rounding of that chain
  T ux = mx / rho, uy = my / rho, uz = mz / rho;
  if (p.force) {
    ux = ux + Fx / (T(2) * rho);
    uy = uy + Fy / (T(2) * rho);
    uz = uz + Fz / (T(2) * rho);
  }
  if (p.bf_on[0]) ux = ux + k.bf[0] / (T(2) * rho);
  if (p.bf_on[1]) uy = uy + k.bf[1] / (T(2) * rho);
  if (p.bf_on[2]) uz = uz + k.bf[2] / (T(2) * rho);
  if (solid) ux = uy = uz = T(0);
  const T usqr = ux * ux + uy * uy + uz * uz;
  speed[at] = p.speed == 1 ? sqrt(usqr) : (p.speed == 2 ? temp : T(0));

  if (!p.collide) {
    // the collisionless chain carries the post-face streamed distribution
#pragma unroll
    for (int q = 0; q < Q; ++q) out[q * N + at] = f[q];
    return;
  }
  const T third = T(0.5) * usqr * k.inv_cs2;
  collide<Q, T, MRT, 0>(p, f, rho, ux, uy, uz, third, solid, p.guo != 0, rho, Fx, Fy, Fz, mean,
                        out, N, at);
  if constexpr (TWO)
    collide<Q, T, MRT, 1>(p, g, temp, ux, uy, uz, third, solid, false, rho, Fx, Fy, Fz, mean,
                          gout, N, at);
}

// Pass 1 of the mean density: each block streams its aligned chunk of
// LBM_DENSITY_BLOCK flattened cells through lattice 1's faces, sums ρ in
// direction order and reduces the chunk pairwise (cells past the grid add
// zeros, which is exact), left + right at every level as tree_mean does.
template <int Q, typename T>
__global__ void __launch_bounds__(LBM_DENSITY_BLOCK)
lbm_density_kernel(const T* __restrict__ fpc, const int8_t* __restrict__ media,
                   const T* __restrict__ avec, T* __restrict__ partial) {
  __shared__ T s[LBM_DENSITY_BLOCK];
  const LbmPlan& p = c_plan;
  const long long N = p.nx * p.ny * p.nz;
  T rho = T(0);
  Cell c;
  if (thread_cell(p, true, c)) {
    T f[Q];
    load_lattice<Q, T>(p, p.lat[0], fpc, media, avec, N, c, f);
    rho = f[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) rho = rho + f[q];
  }
  const int t = threadIdx.x;
  s[t] = rho;
  __syncthreads();
  for (int stride = 1; stride < LBM_DENSITY_BLOCK; stride <<= 1) {
    if ((t & (2 * stride - 1)) == 0) s[t] = s[t] + s[t + stride];
    __syncthreads();
  }
  if (t == 0) partial[blockIdx.x] = s[0];
}

// Pass 2, one block: the tree over the m partial sums, zero-padded to a
// power of two.  Each thread first reduces its aligned run of `chunk`
// partials pairwise (a stack of subtree sums, merged as a binary counter
// carries), then the block reduces the threads' sums; thread 0 writes
// the total times 1/N.
template <typename T>
__global__ void __launch_bounds__(LBM_MEAN_THREADS)
lbm_mean_kernel(const T* __restrict__ partial, long long m, int chunk, T inv_n,
                T* __restrict__ mean) {
  __shared__ T s[LBM_MEAN_THREADS];
  const int t = threadIdx.x;
  T stack[32];
  int depth = 0;
  for (int i = 0; i < chunk; ++i) {
    const long long j = (long long)t * chunk + i;
    T v = j < m ? partial[j] : T(0);
    for (int b = i; b & 1; b >>= 1) v = stack[--depth] + v;
    stack[depth++] = v;
  }
  s[t] = stack[0];
  __syncthreads();
  for (int stride = 1; stride < LBM_MEAN_THREADS; stride <<= 1) {
    if ((t & (2 * stride - 1)) == 0) s[t] = s[t] + s[t + stride];
    __syncthreads();
  }
  if (t == 0) mean[0] = s[0] * inv_n;
}

cudaError_t copy_plan(const LbmPlan& p, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_plan, &p, sizeof(LbmPlan), 0, cudaMemcpyHostToDevice,
                                 stream);
}

template <int Q, typename T, bool TWO, bool MRT>
cudaError_t launch(const void* fpc, const void* gpc, const void* media, const void* avec,
                   const void* mean, void* out, void* gout, void* speed, const LbmPlan& p,
                   cudaStream_t stream) {
  // one thread a cell: x and y from the grid, z along the block; a 2-D
  // plan over the flattened grid
  const bool flat = p.nz == 1;
  const int threads = flat || p.nz >= 256 ? 256 : (int)((p.nz + 31) / 32 * 32);
  const dim3 grid = flat ? dim3((unsigned)((p.nx * p.ny + threads - 1) / threads))
                         : dim3((unsigned)((p.nz + threads - 1) / threads),
                                (unsigned)p.ny, (unsigned)p.nx);
  cudaError_t err = copy_plan(p, stream);
  if (err != cudaSuccess) return err;
  lbm_substep_kernel<Q, T, TWO, MRT><<<grid, threads, 0, stream>>>(
      (const T*)fpc, (const T*)gpc, (const int8_t*)media, (const T*)avec, (const T*)mean,
      (T*)out, (T*)gout, (T*)speed, flat);
  return cudaGetLastError();
}

template <int Q, typename T>
cudaError_t dispatch(const void* fpc, const void* gpc, const void* media, const void* avec,
                     const void* mean, void* out, void* gout, void* speed, const LbmPlan& p,
                     cudaStream_t stream) {
  const bool mrt = p.mrt[0] || (p.two_lattice && p.mrt[1]);
  if (p.two_lattice)
    return mrt ? launch<Q, T, true, true>(fpc, gpc, media, avec, mean, out, gout, speed, p,
                                          stream)
               : launch<Q, T, true, false>(fpc, gpc, media, avec, mean, out, gout, speed, p,
                                           stream);
  return mrt ? launch<Q, T, false, true>(fpc, gpc, media, avec, mean, out, gout, speed, p,
                                         stream)
             : launch<Q, T, false, false>(fpc, gpc, media, avec, mean, out, gout, speed, p,
                                          stream);
}

template <int Q, typename T>
cudaError_t density_mean(const void* fpc, const void* media, const void* avec, void* partial,
                         void* mean, double inv_n, const LbmPlan& p, cudaStream_t stream) {
  const long long cells = p.nx * p.ny * p.nz;
  const long long m = (cells + LBM_DENSITY_BLOCK - 1) / LBM_DENSITY_BLOCK;
  long long m2 = 1;
  while (m2 < m) m2 <<= 1;
  const int chunk = m2 > LBM_MEAN_THREADS ? (int)(m2 / LBM_MEAN_THREADS) : 1;
  cudaError_t err = copy_plan(p, stream);
  if (err != cudaSuccess) return err;
  lbm_density_kernel<Q, T><<<(unsigned)m, LBM_DENSITY_BLOCK, 0, stream>>>(
      (const T*)fpc, (const int8_t*)media, (const T*)avec, (T*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lbm_mean_kernel<T><<<1, LBM_MEAN_THREADS, 0, stream>>>((const T*)partial, m, chunk,
                                                          (T)inv_n, (T*)mean);
  return cudaGetLastError();
}

template <int Q>
void tables(int* e, int* op) {
  using D = Lattice<Q>;
  for (int q = 0; q < Q; ++q) {
    e[3 * q] = D::ex(q);
    e[3 * q + 1] = D::ey(q);
    e[3 * q + 2] = D::ez(q);
    op[q] = D::op(q);
  }
}

}  // namespace

// The plan checks both entry points share: the per-lattice limits, the
// perturbed rows' table, 32-bit cell indices, and the grid's y and z
// extents of a 3-D launch (at most 65535).
static bool plan_ok(const LbmPlan& p, const void* avec) {
  for (int l = 0; l < 2; ++l) {
    if (p.lat[l].n_faces > LBM_MAX_FACES || p.lat[l].n_post > LBM_MAX_POST) return false;
    for (int k = 0; k < p.lat[l].n_post; ++k)
      if (p.lat[l].post[k].perturb >= 0 && !avec) return false;
  }
  if (p.nx * p.ny * p.nz > 0x7fffffffLL) return false;
  return p.nz == 1 || (p.nx <= 65535 && p.ny <= 65535);
}

// fpc, out (and on two-lattice plans gpc, gout): (q, nx, ny, nz); media:
// (nx, ny, nz) int8 or null; avec: the (n, ny) a(y) rows of the perturbed
// inlets, or null; mean: one value, read on Smagorinsky plans; speed:
// (nx, ny, nz); float32, or float64 where is_double.  `plan` is a host
// pointer, copied to constant memory on `stream` before the launch.
extern "C" cudaError_t mtt_lbm_substep(const void* fpc, const void* gpc, const void* media,
                                       const void* avec, const void* mean, void* out,
                                       void* gout, void* speed, int q, int is_double,
                                       const LbmPlan* plan, cudaStream_t stream) {
  const LbmPlan& p = *plan;
  if (!plan_ok(p, avec) || (p.two_lattice && (!gpc || !gout)) || (p.smag && !mean))
    return cudaErrorInvalidValue;
#define LBM_DISPATCH(Q)                                                                    \
  return is_double                                                                         \
             ? dispatch<Q, double>(fpc, gpc, media, avec, mean, out, gout, speed, p, stream) \
             : dispatch<Q, float>(fpc, gpc, media, avec, mean, out, gout, speed, p, stream)
  if (q == 9) LBM_DISPATCH(9);
  if (q == 19) LBM_DISPATCH(19);
  if (q == 27) LBM_DISPATCH(27);
#undef LBM_DISPATCH
  return cudaErrorInvalidValue;
}

// The mean over the grid of lattice 1's streamed density, into `mean` (one
// value): `partial` holds ceil(nx ny nz / LBM_DENSITY_BLOCK) values of the
// distribution's type; inv_n = 1 / (nx ny nz).
extern "C" cudaError_t mtt_lbm_density_mean(const void* fpc, const void* media,
                                            const void* avec, void* partial, void* mean,
                                            int q, int is_double, double inv_n,
                                            const LbmPlan* plan, cudaStream_t stream) {
  const LbmPlan& p = *plan;
  if (!plan_ok(p, avec) || !partial || !mean) return cudaErrorInvalidValue;
#define LBM_MEAN(Q)                                                                     \
  return is_double ? density_mean<Q, double>(fpc, media, avec, partial, mean, inv_n, p, \
                                             stream)                                    \
                   : density_mean<Q, float>(fpc, media, avec, partial, mean, inv_n, p, stream)
  if (q == 9) LBM_MEAN(9);
  if (q == 19) LBM_MEAN(19);
  if (q == 27) LBM_MEAN(27);
#undef LBM_MEAN
  return cudaErrorInvalidValue;
}

// The compiled-in e (q x 3) and op (q) tables of stencil q.
extern "C" cudaError_t mtt_lbm_tables(int q, int* e, int* op) {
  if (q == 9) tables<9>(e, op);
  else if (q == 19) tables<19>(e, op);
  else if (q == 27) tables<27>(e, op);
  else return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The plan's layout, for the wrapper to hold its ctypes mirror to: the
// size, then the offsets of lat, lat[1], d, d.msm, f, f.msm.
extern "C" int mtt_lbm_plan_layout(int64_t* out) {
  out[0] = (int64_t)sizeof(LbmPlan);
  out[1] = (int64_t)offsetof(LbmPlan, lat);
  out[2] = (int64_t)(offsetof(LbmPlan, lat) + sizeof(LbmFaces));
  out[3] = (int64_t)offsetof(LbmPlan, d);
  out[4] = (int64_t)(offsetof(LbmPlan, d) + offsetof(LbmCoef<double>, msm));
  out[5] = (int64_t)offsetof(LbmPlan, f);
  out[6] = (int64_t)(offsetof(LbmPlan, f) + offsetof(LbmCoef<float>, msm));
  return 0;
}
