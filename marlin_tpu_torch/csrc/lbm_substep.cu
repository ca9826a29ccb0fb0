// One whole lattice Boltzmann substep in one pass: the port of
// marlin_tpu/pallas_lbm.py:224 _make_kernel (called through fused_substep),
// for D3Q19 and D3Q27 BGK chains with face bounce-back, a body force,
// binary media (obstacle bounce-back and solid masking) and the post-stream
// Zou-He fixed-order and zero-gradient faces.
//
//   read  fpc_old (q, nx, ny, nz), pull-streamed, periodic on every axis
//         media   (nx, ny, nz) int8 code (0 solid, 1 fluid, -1 neither)
//   write fpc_new (q, nx, ny, nz), speed (nx, ny, nz)
//
// Bound on an H100 SXM: bytes.  Each cell reads q + 1 values and writes
// q + 1 (at 256^3 with D3Q19 in float32 and int8 media, 157 B a cell,
// 2.63 GB a substep, 0.79 ms at 3.35 TB/s); its ~300 flops are an order of
// magnitude under their bound.  The design follows from that:
//
// * one thread a cell, z the fastest index, so every direction's pull read
//   and every write is coalesced; x and y come from the grid and the
//   periodic neighbours are computed once a cell, so a direction's source
//   address is a few integer adds.  The TPU kernel's x-block pipeline, its
//   VMEM carry of the previous block's last plane and its block choice
//   exist for the TPU's sequential grid and are not carried over;
// * the q streamed values stay in registers from the read to the write.
//   The stencils' e and op tables are compiled in (the template on Q) so
//   that every direction index is static: a run-time index into the
//   register array would send it to local memory.  The wrapper holds the
//   compiled tables to the plan's once (mtt_lbm_tables);
// * the plan (weights, 1/tau, body force, the bounce-back faces in deck
//   order with -1 for the obstacle slot, the post-stream faces with their
//   Zou-He coefficients) is one struct in constant memory, copied on the
//   launch's stream before it: the face loops index it at run time, which
//   constant memory serves directly (all threads of a warp read the same
//   entry);
// * the post-stream faces run in deck order, each on the state the earlier
//   ones left.  The TPU kernel holds whole planes; a thread holds one cell,
//   so a zero-gradient face cell must start from its inner neighbour's
//   state after the earlier faces.  That dependence is a chain, not a tree
//   (a zero-gradient face replaces every direction), so each thread walks
//   the faces backwards to the cell its state starts from, streams that
//   cell, and replays the faces forwards.  Only face cells ever start from
//   another cell.

#include <cuda_runtime.h>
#include <stdint.h>

#define LBM_MAX_Q 27
#define LBM_MAX_FACES 8
#define LBM_MAX_POST 8

struct LbmPost {
  int32_t kind;  // 0: Zou-He fixed-order, 1: zero-gradient
  int32_t axis, side;
  uint32_t sum1, sum2, rows;  // direction bitmasks
  double a, b;                // m = a * facesum + b
  double cm[LBM_MAX_Q];       // f[d] = f[op[d]] + cm[d] * m for d in rows
};

struct LbmPlan {
  int64_t nx, ny, nz;
  double w[LBM_MAX_Q];
  double inv_tau, inv_cs2, inv_cs4;
  double bf[3];
  int32_t n_faces;
  int32_t face_axis[LBM_MAX_FACES];  // -1: obstacle (wall) bounce-back
  int32_t face_side[LBM_MAX_FACES];
  uint32_t face_dirs[LBM_MAX_FACES];  // replaced directions, bitmask
  int32_t n_post;
  int32_t speed;  // 1: write |u|, 0: write zeros
  LbmPost post[LBM_MAX_POST];
};

__constant__ LbmPlan c_plan;

// The velocity set of stencil Q: constexpr functions, so that a direction
// index folds to a constant once the direction loops unroll.
template <int Q>
struct Lattice;

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

// The cell whose state after face `level` becomes this cell's final state.
__device__ __forceinline__ Cell cell_at_level(const LbmPlan& p, Cell c, int level) {
  for (int k = p.n_post; k > level; --k) {
    const LbmPost& bc = p.post[k - 1];
    if (bc.kind == 1 && on_face(p, bc.axis, bc.side, c)) c = inner(p, bc, c);
  }
  return c;
}

// Pull stream of every direction at cell c, with face and obstacle
// bounce-back from the unstreamed distribution and solid masking.  Every
// bounce-back rule, in whatever deck order, writes the same value (the
// opposite direction at the cell), so they reduce to one direction mask.
template <int Q, typename T>
__device__ __forceinline__ void stream_cell(const LbmPlan& p, const T* __restrict__ fpc,
                                            const int8_t* __restrict__ media, long long N,
                                            Cell c, T (&f)[Q]) {
  using L = Lattice<Q>;
  const int ny = (int)p.ny, nz = (int)p.nz;
  const Around xs(c.x, (int)p.nx), ys(c.y, ny), zs(c.z, nz);
  const int at = cell_index(p, c);
  const bool solid = media && media[at] == 0;
  const bool fluid = media && media[at] >= 1;
  uint32_t bounce = 0;  // directions replaced by face bounce-back here
  bool wall = false;    // obstacle bounce-back in the plan
  for (int i = 0; i < p.n_faces; ++i) {
    if (p.face_axis[i] < 0) wall = true;
    else if (on_face(p, p.face_axis[i], p.face_side[i], c)) bounce |= p.face_dirs[i];
  }
  wall = wall && fluid;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int src = (xs.v[1 - L::ex(q)] * ny + ys.v[1 - L::ey(q)]) * nz + zs.v[1 - L::ez(q)];
    T a = fpc[q * N + src];
    if (((bounce >> q) & 1u) || (q != 0 && wall && media[src] == 0))
      a = fpc[L::op(q) * N + at];
    f[q] = solid ? T(0) : a;
  }
}

template <int Q, typename T>
__global__ void __launch_bounds__(256)
lbm_substep_kernel(const T* __restrict__ fpc, const int8_t* __restrict__ media,
                   T* __restrict__ out, T* __restrict__ speed) {
  using L = Lattice<Q>;
  const LbmPlan& p = c_plan;
  const Cell c = {(int)blockIdx.z, (int)blockIdx.y, (int)(blockIdx.x * blockDim.x + threadIdx.x)};
  if (c.z >= p.nz) return;
  const long long N = p.nx * p.ny * p.nz;
  const int at = cell_index(p, c);

  // the post-stream faces in deck order, on the cells they lie on
  bool on_post = false;
  for (int k = 0; k < p.n_post; ++k) on_post |= on_face(p, p.post[k].axis, p.post[k].side, c);
  T f[Q];
  stream_cell<Q, T>(p, fpc, media, N, on_post ? cell_at_level(p, c, 0) : c, f);
  for (int k = 1; on_post && k <= p.n_post; ++k) {
    const LbmPost& bc = p.post[k - 1];
    const Cell ck = cell_at_level(p, c, k);
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
    const T m = T(bc.a) * fsum + T(bc.b);  // lbm_fused.apply_zouhe
    T g[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) g[q] = f[q];
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if ((bc.rows >> q) & 1u) f[q] = solid_k ? T(0) : g[L::op(q)] + T(bc.cm[q]) * m;
  }

  // moments (reference LBMComputeDensity / LBMComputeVelocity)
  const bool solid = media && media[at] == 0;
  T rho = f[0], mx = T(0), my = T(0), mz = T(0);
  bool fx = true, fy = true, fz = true;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (q > 0) rho = rho + f[q];
    if (L::ex(q)) { const T t = L::ex(q) > 0 ? f[q] : -f[q]; mx = fx ? t : mx + t; fx = false; }
    if (L::ey(q)) { const T t = L::ey(q) > 0 ? f[q] : -f[q]; my = fy ? t : my + t; fy = false; }
    if (L::ez(q)) { const T t = L::ez(q) > 0 ? f[q] : -f[q]; mz = fz ? t : mz + t; fz = false; }
  }
  // u = m / rho (+ F / (2 rho) for each non-zero body force), zero at
  // solids (rho = 0 there), with the eager chain's operations: every
  // product, sum and quotient below is one rounding of that chain (the
  // library is built without contraction)
  T ux = mx / rho, uy = my / rho, uz = mz / rho;
  if (p.bf[0] != 0.0) ux = ux + T(p.bf[0]) / (T(2) * rho);
  if (p.bf[1] != 0.0) uy = uy + T(p.bf[1]) / (T(2) * rho);
  if (p.bf[2] != 0.0) uz = uz + T(p.bf[2]) / (T(2) * rho);
  if (solid) ux = uy = uz = T(0);
  const T usqr = ux * ux + uy * uy + uz * uz;
  speed[at] = p.speed ? sqrt(usqr) : T(0);

  // equilibrium (reference LBMEquilibrium.C:42-66) and BGK collision
  const T inv_cs2 = T(p.inv_cs2), inv_cs4 = T(p.inv_cs4), inv_tau = T(p.inv_tau);
  const T third = T(0.5) * usqr * inv_cs2;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    T feq;
    if (L::ex(q) == 0 && L::ey(q) == 0 && L::ez(q) == 0) {
      feq = T(p.w[q]) * rho * (T(1) - third);
    } else {
      T edotu = T(0);
      bool fe = true;
      if (L::ex(q)) { edotu = L::ex(q) > 0 ? ux : -ux; fe = false; }
      if (L::ey(q)) { const T t = L::ey(q) > 0 ? uy : -uy; edotu = fe ? t : edotu + t; fe = false; }
      if (L::ez(q)) { const T t = L::ez(q) > 0 ? uz : -uz; edotu = fe ? t : edotu + t; }
      const T second = edotu * inv_cs2 + T(0.5) * edotu * edotu * inv_cs4;
      feq = T(p.w[q]) * rho * (T(1) + second - third);
    }
    const T fneq = f[q] - feq;
    const T u = feq + fneq - fneq * inv_tau;
    out[q * N + at] = solid ? T(0) : u;
  }
}

template <int Q, typename T>
cudaError_t launch(const void* fpc, const void* media, void* out, void* speed,
                   const LbmPlan& p, cudaStream_t stream) {
  // one thread a cell: x and y from the grid, z along the block
  const int threads = p.nz >= 256 ? 256 : (int)((p.nz + 31) / 32 * 32);
  const dim3 grid((unsigned)((p.nz + threads - 1) / threads), (unsigned)p.ny,
                  (unsigned)p.nx);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_plan, &p, sizeof(LbmPlan), 0,
                                            cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return err;
  lbm_substep_kernel<Q, T><<<grid, threads, 0, stream>>>(
      (const T*)fpc, (const int8_t*)media, (T*)out, (T*)speed);
  return cudaGetLastError();
}

template <int Q>
void tables(int* e, int* op) {
  using L = Lattice<Q>;
  for (int q = 0; q < Q; ++q) {
    e[3 * q] = L::ex(q);
    e[3 * q + 1] = L::ey(q);
    e[3 * q + 2] = L::ez(q);
    op[q] = L::op(q);
  }
}

}  // namespace

// fpc, out: (q, nx, ny, nz); media: (nx, ny, nz) int8 or null; speed:
// (nx, ny, nz); float32, or float64 where is_double.  `plan` is a host
// pointer, copied to constant memory on `stream` before the launch.
extern "C" cudaError_t mtt_lbm_substep(const void* fpc, const void* media, void* out,
                                       void* speed, int q, int is_double,
                                       const LbmPlan* plan, cudaStream_t stream) {
  const LbmPlan& p = *plan;
  if (p.n_faces > LBM_MAX_FACES || p.n_post > LBM_MAX_POST) return cudaErrorInvalidValue;
  // cell indices are 32-bit; the grid's y and z extents are at most 65535
  if (p.nx * p.ny * p.nz > 0x7fffffffLL || p.nx > 65535 || p.ny > 65535)
    return cudaErrorInvalidValue;
  if (q == 19)
    return is_double ? launch<19, double>(fpc, media, out, speed, p, stream)
                     : launch<19, float>(fpc, media, out, speed, p, stream);
  if (q == 27)
    return is_double ? launch<27, double>(fpc, media, out, speed, p, stream)
                     : launch<27, float>(fpc, media, out, speed, p, stream);
  return cudaErrorInvalidValue;
}

// The compiled-in e (q x 3) and op (q) tables of stencil q.
extern "C" cudaError_t mtt_lbm_tables(int q, int* e, int* op) {
  if (q == 19) tables<19>(e, op);
  else if (q == 27) tables<27>(e, op);
  else return cudaErrorInvalidValue;
  return cudaSuccess;
}
