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
// 1.55 ms).  MRT adds q^2 multiplies and q^2 adds a lattice-cell, and the
// library is built with -fmad=false, so each issues on its own at half
// the 67 TFLOP/s that counts an FMA as two: 24 GFLOP a two-lattice D3Q19
// substep at 256^3, 0.72 ms at 33.5 TFLOP/s; the whole Pebbles plan is
// 2,125 operations a cell (chip_smoke.py lbm_flops), 1.06 ms, still under
// its byte bound.  What holds the kernel is neither (lbm_probe.py): one
// thread a cell copies its planes at 85% of the bound, but its moments and
// collision wait on its loads and its stores on them, with 16 warps an SM.
// The design follows from that:
//
// * 3-D plans walk bricks (lbm_brick_kernel): one x-plane, `by` rows of y
//   and every z.  A producer warp brings in, for each lattice and
//   direction, the source rows a brick pulls from, whole, by bulk copies
//   (cp.async.bulk) completed on a full mbarrier, the media rows of three
//   planes beside them; the consumer warps update the cells out of shared
//   memory, the z shift and its wrap a read there, and release the stage
//   on an empty mbarrier.  Blocks persist over the bricks with `stages` in
//   flight; no block-wide sync after the barriers' set-up, so a warp held
//   by a global read (bounce-back from the cell's unstreamed value, a face
//   cell's path) holds no other.  by, stages and threads come from the host
//   (lbm_fused.brick_plan), the register cap of each instantiation from
//   kBrickBlocks: warps an SM mattered most on the card;
// * on two-lattice plans each lattice's streamed values go back to the
//   cell's own slots of the stage (slot (q, j, (z - e_z) mod nz) is read by
//   that cell alone), then T = Σg, f's moments and both collisions read
//   them from there, one lattice live at a time, the two collisions on one
//   loop that is not unrolled (its code, the MRT rows unrolled, once: two
//   inlined copies ran slower on the card); each lattice's MRT matrix is
//   copied to shared memory, rows padded to 16 bytes, read 16 bytes a load;
// * 2-D plans and the extents the brick does not take (rows not a
//   multiple of 16 bytes, media rows of 3-D plans not a multiple of 16, a
//   stage that does not fit a block, a buffer not 16-byte aligned) take the
//   flat kernel (lbm_substep_kernel): one thread a cell, z the fastest
//   index, both lattices' q values in registers from the read to the
//   write.  Both kernels run the same per-cell steps and give the same
//   bits; the host chooses by shape.  The TPU kernel's x-block pipeline,
//   its VMEM carry of the previous block's last plane and its block choice
//   exist for the TPU's sequential grid and are not carried over;
// * the stencils' e and op tables are compiled in (the template on Q) so
//   that every direction index is static: a run-time index into a register
//   array would send it to local memory.  The wrapper holds the compiled
//   tables to the plan's once (mtt_lbm_tables).  The second lattice and
//   MRT change the set of live registers and the code size, so they are
//   template parameters; the projection, the forces, the collisionless
//   chain and which lattice runs MRT are warp-uniform branches on the plan;
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
//   cell from device memory, and replays the faces forwards, for each
//   lattice with its own faces.  Only face cells ever start from another
//   cell, in both kernels;
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

#include "lbm_substep.cuh"

namespace {

// The flat kernel: one thread a cell, both lattices held from load to
// store.  2-D plans and the extents the brick does not take.
template <int Q, typename T, bool TWO, bool MRT>
__global__ void __launch_bounds__(256)
lbm_substep_kernel(const T* __restrict__ fpc, const T* __restrict__ gpc,
                   const int8_t* __restrict__ media, const T* __restrict__ avec,
                   const T* __restrict__ mean, T* __restrict__ out,
                   T* __restrict__ gout, T* __restrict__ speed, bool flat) {
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
  // the thermal lattice's zeroth moment (LBMComputeDensity on g)
  T temp = T(0);
  if constexpr (TWO) {
    temp = g[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) temp = temp + g[q];
  }
  const Flow<T> fl = flow<Q, T>(p, f, temp, solid);
  speed[at] = carried(p, fl, temp);
  if (!p.collide) {
    // the collisionless chain carries the post-face streamed distribution
#pragma unroll
    for (int q = 0; q < Q; ++q) out[q * N + at] = f[q];
    return;
  }
  const T third = T(0.5) * fl.usqr * k.inv_cs2;
  collide<Q, T, MRT>(p, 0, f, fl.rho, fl.ux, fl.uy, fl.uz, third, solid, p.guo != 0, fl.rho,
                     fl.Fx, fl.Fy, fl.Fz, mean, k.msm[0], out, N, at);
  if constexpr (TWO)
    collide<Q, T, MRT>(p, 1, g, temp, fl.ux, fl.uy, fl.uz, third, solid, false, fl.rho, fl.Fx,
                       fl.Fy, fl.Fz, mean, k.msm[1], gout, N, at);
}

// One cell of the brick kernel (row j of its brick).  One lattice streams
// straight into registers.  Two lattices go in two phases: first each
// lattice's streamed values (the bounce-back's global reads of a lattice
// issued together) go back to the cell's own slots; then T = Σg and f's
// moments, and each lattice in turn read from its slots, collided and
// stored, on a loop that is not unrolled: at most one lattice's q values
// are live, and the collision's code (the MRT rows unrolled) is there
// once.
template <int Q, typename T, bool TWO, bool MRT>
__device__ __forceinline__ void brick_cell(const LbmPlan& p, Stage<T> st, const T* msm, Cell c,
                                           int j, const T* __restrict__ fpc,
                                           const T* __restrict__ gpc,
                                           const int8_t* __restrict__ media,
                                           const T* __restrict__ avec,
                                           const T* __restrict__ mean, T* __restrict__ out,
                                           T* __restrict__ gout, T* __restrict__ speed) {
  constexpr int S = kMsmStride<Q, T>;
  const LbmCoef<T>& k = coef<T>();
  const long long N = p.nx * p.ny * p.nz;
  const int at = cell_index(p, c);
  const bool solid = st.media && st.m(0, j, 0, c.z) == 0;
  T temp = T(0);
  T f[Q];
  if constexpr (TWO) {
    settle<Q, T>(p, p.lat[1], st, 1, gpc, media, avec, N, c, j);
    settle<Q, T>(p, p.lat[0], st, 0, fpc, media, avec, N, c, j);
    forget();
    T g[Q];
    settled<Q, T>(st, 1, j, c.z, g);
    temp = g[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) temp = temp + g[q];
    forget();
    settled<Q, T>(st, 0, j, c.z, f);
  } else {
    brick_lattice<Q, T>(p, p.lat[0], st, 0, fpc, media, avec, N, c, j, f);
  }
  const Flow<T> fl = flow<Q, T>(p, f, temp, solid);
  speed[at] = carried(p, fl, temp);
  if (!p.collide) {
#pragma unroll
    for (int q = 0; q < Q; ++q) out[q * N + at] = f[q];
    return;
  }
  const T third = T(0.5) * fl.usqr * k.inv_cs2;
  if constexpr (!TWO) {
    collide<Q, T, MRT, S>(p, 0, f, fl.rho, fl.ux, fl.uy, fl.uz, third, solid, p.guo != 0,
                          fl.rho, fl.Fx, fl.Fy, fl.Fz, mean, msm, out, N, at);
  } else {
    forget();
#pragma unroll 1
    for (int l = 0; l < 2; ++l) {
      T v[Q];
      settled<Q, T>(st, l, j, c.z, v);
      collide<Q, T, MRT, S>(p, l, v, l ? temp : fl.rho, fl.ux, fl.uy, fl.uz, third, solid,
                            l == 0 && p.guo != 0, fl.rho, fl.Fx, fl.Fy, fl.Fz, mean,
                            msm + l * Q * S, l ? gout : out, N, at);
      forget();
    }
  }
}

// The brick kernel of 3-D plans: persistent blocks walk the bricks, warp 0
// bringing them in, the other warps updating their cells out of the stage.
template <int Q, typename T, bool TWO, bool MRT>
__global__ void __launch_bounds__((kBrickThreads<Q, TWO>), (kBrickBlocks<Q, TWO, MRT>))
lbm_brick_kernel(const T* __restrict__ fpc, const T* __restrict__ gpc,
                 const int8_t* __restrict__ media, const T* __restrict__ avec,
                 const T* __restrict__ mean, T* __restrict__ out, T* __restrict__ gout,
                 T* __restrict__ speed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LbmPlan& p = c_plan;
  const int nz = (int)p.nz, by = p.brick.by;
  const BrickLayout lay = brick_layout(Q, sizeof(T), TWO ? 2 : 1, media != nullptr, MRT, by,
                                       p.brick.stages, nz);
  const T* msm = MRT ? brick_msm<Q, T, TWO>(smem + lay.msm_off) : nullptr;
  const BrickPipe pipe = brick_pipe(p, lay, smem);
  if (threadIdx.x < 32) {
    brick_produce<Q, T, true>(p, pipe, lay.lattice_bytes, lay.media_off, fpc,
                              TWO ? gpc : nullptr, media);
    return;
  }
  long long k = 0;
  for (long long b = blockIdx.x; b < pipe.bricks; b += gridDim.x, ++k) {
    const Stage<T> st = stage_at<T>(brick_acquire(pipe, k), lay.lattice_bytes, lay.media_off,
                                    TWO, media != nullptr, by, nz);
    const Brick br = brick_at(p, b);
    for (int i = threadIdx.x - 32; i < br.rows * nz; i += blockDim.x - 32) {
      const int j = i / nz;
      brick_cell<Q, T, TWO, MRT>(p, st, msm, Cell{br.x, br.y0 + j, i - j * nz}, j, fpc, gpc,
                                 media, avec, mean, out, gout, speed);
    }
    brick_release(pipe, k);
  }
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

// The brick plan against what the brick kernel takes: a 3-D plan, rows of
// 16-byte multiples (media rows too), a producer and at least one
// consumer warp, and the shared memory brick_layout gives, within the
// 227 KB a block may have.
template <int Q, typename T>
bool brick_ok(const LbmPlan& p, bool media) {
  const LbmBrick& b = p.brick;
  if (Q == 9 || p.nz == 1 || b.by < 1 || b.stages < 1 || b.threads < 64 ||
      b.threads > (p.two_lattice ? kBrickThreads<Q, true> : kBrickThreads<Q, false>) ||
      b.threads % 32 || (p.nz * (long long)sizeof(T)) % 16 ||
      (media && p.nz % 16))
    return false;
  const bool mrt = p.mrt[0] || (p.two_lattice && p.mrt[1]);
  const BrickLayout l = brick_layout(Q, sizeof(T), p.two_lattice ? 2 : 1, media, mrt, b.by,
                                     b.stages, p.nz);
  return l.smem == b.smem && l.smem <= 232448;
}

// Blocks resident on the card at once for the brick kernel at this block
// shape, cached by device, shared memory and threads; the shared-memory
// limit is raised on the first launch of each.
struct Resident {
  int dev = -1, smem = 0, threads = 0, blocks = 0;
};

template <int Q, typename T, bool TWO, bool MRT>
cudaError_t launch_brick(const void* fpc, const void* gpc, const void* media, const void* avec,
                         const void* mean, void* out, void* gout, void* speed,
                         const LbmPlan& p, cudaStream_t stream) {
  static Resident r;
  auto kernel = lbm_brick_kernel<Q, T, TWO, MRT>;
  const LbmBrick& b = p.brick;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (r.dev != dev || r.smem != b.smem || r.threads != b.threads) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, b.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, b.threads, b.smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    r = {dev, b.smem, b.threads, per_sm * sms};
  }
  const long long bricks = p.nx * ((p.ny + b.by - 1) / b.by);
  err = copy_plan(p, stream);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bricks < r.blocks ? bricks : r.blocks), b.threads, b.smem, stream>>>(
      (const T*)fpc, (const T*)gpc, (const int8_t*)media, (const T*)avec, (const T*)mean,
      (T*)out, (T*)gout, (T*)speed);
  return cudaGetLastError();
}

// The brick kernel where the plan has a brick walk (and the buffers are
// 16-byte aligned, as the bulk copies need: torch's allocations are), the
// flat kernel otherwise; both give the same bits.
template <int Q, typename T, bool TWO, bool MRT>
cudaError_t launch_any(const void* fpc, const void* gpc, const void* media, const void* avec,
                       const void* mean, void* out, void* gout, void* speed, const LbmPlan& p,
                       cudaStream_t stream) {
  if constexpr (Q != 9) {
    const bool aligned =
        (((uintptr_t)fpc | (uintptr_t)gpc | (uintptr_t)media) & 15) == 0;
    if (p.brick.by > 0 && aligned)
      return launch_brick<Q, T, TWO, MRT>(fpc, gpc, media, avec, mean, out, gout, speed, p,
                                          stream);
  }
  return launch<Q, T, TWO, MRT>(fpc, gpc, media, avec, mean, out, gout, speed, p, stream);
}

template <int Q, typename T>
cudaError_t dispatch(const void* fpc, const void* gpc, const void* media, const void* avec,
                     const void* mean, void* out, void* gout, void* speed, const LbmPlan& p,
                     cudaStream_t stream) {
  if (p.brick.by > 0 && !brick_ok<Q, T>(p, media != nullptr)) return cudaErrorInvalidValue;
  const bool mrt = p.mrt[0] || (p.two_lattice && p.mrt[1]);
  if (p.two_lattice)
    return mrt ? launch_any<Q, T, true, true>(fpc, gpc, media, avec, mean, out, gout, speed, p,
                                              stream)
               : launch_any<Q, T, true, false>(fpc, gpc, media, avec, mean, out, gout, speed,
                                               p, stream);
  return mrt ? launch_any<Q, T, false, true>(fpc, gpc, media, avec, mean, out, gout, speed, p,
                                             stream)
             : launch_any<Q, T, false, false>(fpc, gpc, media, avec, mean, out, gout, speed, p,
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
// size, then the offsets of lat, lat[1], d, d.msm, f, f.msm, brick.
extern "C" int mtt_lbm_plan_layout(int64_t* out) {
  out[0] = (int64_t)sizeof(LbmPlan);
  out[1] = (int64_t)offsetof(LbmPlan, lat);
  out[2] = (int64_t)(offsetof(LbmPlan, lat) + sizeof(LbmFaces));
  out[3] = (int64_t)offsetof(LbmPlan, d);
  out[4] = (int64_t)(offsetof(LbmPlan, d) + offsetof(LbmCoef<double>, msm));
  out[5] = (int64_t)offsetof(LbmPlan, f);
  out[6] = (int64_t)(offsetof(LbmPlan, f) + offsetof(LbmCoef<float>, msm));
  out[7] = (int64_t)offsetof(LbmPlan, brick);
  return 0;
}
