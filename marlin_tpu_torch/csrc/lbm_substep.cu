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
//         the final form also f and feq (q, nx, ny, nz), density (nx, ny, nz),
//         velocity (nx, ny, nz, 3)
//
// On a block of a REAL_SPACE mesh (the sharded branch of the TPU kernel,
// pallas_lbm.py:250-343, :382-399) the flat kernel also reads
//
//   fring, gring (q, H) and mring (H): the halo rings parallel.halo_ring
//         packs from the neighbours' boundary planes (x-lo, x-hi; on a
//         2-D mesh also the y-lo and y-hi rows and the four corner
//         columns, so that diagonal pulls are exact)
//
// and a pull that leaves the block reads its ring in place of the wrap;
// the bounce-back and Zou-He faces are found on the grid's coordinates
// (the plan's offsets and global extents), the perturbed inlet's a(y) on
// the global y.  In the flat kernel that branch is a run-time flag of the
// plan, uniform over a launch (the unsharded plans read the same fields
// with offsets 0).  One-lattice 3-D blocks take the halo brick instead
// (lbm_brick_kernel with HALO, a compile-time form, so the unsharded
// brick's code stays as it was: routing it through the run-time branch
// cost it 7-16%, PERF.md): its producer copies a row that leaves the
// block from the row of the ring that holds it (halo_plane; each ring row is
// nz values at a multiple of nz, so 16-byte aligned wherever the brick
// takes the block), and a post-stream face cell's global path reads the
// rings.  Two-lattice blocks keep the flat form (at 67% of its bound it
// beat the brick on the block, PERF.md §6), 2-D blocks the flat kernel;
// no block takes the plane kernel (the JAX package refuses Smagorinsky
// fusion on a mesh).  Bound of the sharded substep: the unsharded bytes
// plus the rings (2 planes a direction, 1-6% of a block's rows).
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
// * 2-D plans (D2Q9, nz = 1) and the 3-D extents the brick does not take
//   (rows not a multiple of 16 bytes, media rows not a multiple of 16, a
//   stage that does not fit a block, a buffer not 16-byte aligned) take the
//   flat map: one thread a cell, the last axis the fastest index, both
//   lattices' q values in registers from the read to the write
//   (lbm_substep_kernel; on 2-D Smagorinsky plans lbm_plane_kernel, below).
//   On D2Q9 the probe (lbm_probe.py --plans 2d) put the flat kernel's copy
//   at 84-87% of its bound, and a tile walk with the brick's bulk copies
//   (whole x-rows, or segments of them with 16-byte halos) ran slower than
//   it at both 800x200 and 4096x2048: the time is in the collisions, and
//   one thread a cell keeps the most of them in flight.  Every kernel runs
//   the same per-cell steps and gives the same bits; the host chooses by
//   shape.  The TPU kernel's x-block pipeline, its VMEM carry of the
//   previous block's last plane and its block choice exist for the TPU's
//   sequential grid and are not carried over;
// * the last substep of a step on an unsharded one-lattice 3-D plan runs
//   the final form (mtt_lbm_final: the brick or the flat kernel with FINAL),
//   the same cell update that also stores what the eager chain leaves in
//   the deck's buffers: the streamed f after its faces, each direction's
//   equilibrium, the density and the velocity (struct Final), so that no
//   eager substep follows the fused ones.  FINAL is a template parameter,
//   instantiated for those plans only, so the hot form keeps its code;
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
//   the launch's stream only when it differs from the last one copied there
//   (copy_plan): a fused loop's launches share one plan, so none of them
//   copies (one copy a launch from pageable memory cost more than the 2-D
//   kernel at 800x200; a build that passed the plan as a __grid_constant__
//   parameter instead ran the 3-D brick kernel 7-34% slower, and one that
//   read it from device memory ran the kernels 3-49% slower, PERF.md).  Its
//   coefficient tables come in double and in float, each the rounding of
//   the double the eager chain multiplies by, so a float kernel reads its
//   constants without a conversion; constant memory serves a warp that
//   reads one entry at once (every coefficient index below is uniform);
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
// * D2Q9 in float32 is 77 B a cell (36 read, 36 written, the speed and the
//   media byte): 12.3 MB, 3.7 us at 800x200, less than a launch costs, so
//   the shipped 2-D size is the host's: one launch a substep, no copy;
// * the Smagorinsky τ needs the mean density of the whole grid before any
//   cell collides (the TPU kernel's 2-D mode is one block, the mean an
//   in-VMEM reduction).  Atomics add in no fixed order (their bits would
//   change from run to run and differ from the eager chain's), so the plane
//   kernel, the flat map on a cooperative launch (every block resident),
//   runs two passes around a grid-wide barrier: each block's sums of its
//   aligned runs of 256 streamed ρ, then in every block the rest of the
//   same tree (computes/lbm.py tree_mean; above 2048 runs a level spread
//   over the blocks first, behind a second barrier) and the collisions.  A
//   thread's first cell keeps its streamed lattice in registers from one
//   pass to the other; at 800x200 the resident threads outnumber the cells,
//   so no cell streams twice.

#include <cooperative_groups.h>
#include <string.h>

#include "lbm_substep.cuh"

namespace {

// One cell of the flat kernel from its streamed lattice f (lattice 1,
// after its faces): the second lattice's stream, the moments, the carried
// scalar and both collisions, both lattices held from load to store.
// FINAL (one lattice, with a collision): the final form's stores too.
template <int Q, typename T, bool TWO, bool MRT, bool HALO = true, bool FINAL = false>
__device__ __forceinline__ void flat_update(const LbmPlan& p, Cell c, T (&f)[Q],
                                            const T* __restrict__ gpc,
                                            const int8_t* __restrict__ media,
                                            const T* __restrict__ avec,
                                            const T* __restrict__ mean, T* __restrict__ out,
                                            T* __restrict__ gout, T* __restrict__ speed,
                                            Ring<T> gring = {nullptr, nullptr},
                                            Final<T> fin = {}) {
  static_assert(!(FINAL && TWO), "the final form takes one lattice");
  const LbmCoef<T>& k = coef<T>();
  const long long N = p.nx * p.ny * p.nz;
  const int at = cell_index(p, c);
  const bool solid = media && media[at] == 0;
  T g[TWO ? Q : 1];
  if constexpr (TWO) load_lattice<Q, T, HALO>(p, p.lat[1], gpc, media, avec, N, c, g, gring);
  // the thermal lattice's zeroth moment (LBMComputeDensity on g)
  T temp = T(0);
  if constexpr (TWO) {
    temp = g[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) temp = temp + g[q];
  }
  const Flow<T> fl = flow<Q, T>(p, f, temp, solid);
  speed[at] = carried(p, fl, temp);
  if constexpr (FINAL) store_final<Q, T>(fin, f, fl, solid, N, at);
  if (!p.collide) {
    // the collisionless chain carries the post-face streamed distribution
#pragma unroll
    for (int q = 0; q < Q; ++q) out[q * N + at] = f[q];
    return;
  }
  const T third = T(0.5) * fl.usqr * k.inv_cs2;
  collide<Q, T, MRT, Q, FINAL>(p, 0, f, fl.rho, fl.ux, fl.uy, fl.uz, third, solid, p.guo != 0,
                               fl.rho, fl.Fx, fl.Fy, fl.Fz, mean, k.msm[0], out, N, at, fin.feq);
  if constexpr (TWO)
    collide<Q, T, MRT>(p, 1, g, temp, fl.ux, fl.uy, fl.uz, third, solid, false, fl.rho, fl.Fx,
                       fl.Fy, fl.Fz, mean, k.msm[1], gout, N, at);
}

// The flat kernel: one thread a cell.  Every 2-D plan but the Smagorinsky
// ones (y the fastest index of the flattened grid), and the extents of
// 3-D plans the brick does not take; lbm_probe.py also runs a Smagorinsky
// plan on it, its mean given.  FINAL: the final form (fin's stores; built
// for one-lattice plans only, as the brick's).
template <int Q, typename T, bool TWO, bool MRT, bool FINAL = false>
__global__ void __launch_bounds__(256)
lbm_substep_kernel(const T* __restrict__ fpc, const T* __restrict__ gpc,
                   const int8_t* __restrict__ media, const T* __restrict__ avec,
                   const T* __restrict__ mean, T* __restrict__ out,
                   T* __restrict__ gout, T* __restrict__ speed, bool flat,
                   const T* __restrict__ fring, const T* __restrict__ gring,
                   const int8_t* __restrict__ mring, Final<T> fin) {
  const LbmPlan& p = c_plan;
  Cell c;
  if (!thread_cell(p, flat, c)) return;
  T f[Q];
  load_lattice<Q, T>(p, p.lat[0], fpc, media, avec, p.nx * p.ny * p.nz, c, f, {fring, mring});
  flat_update<Q, T, TWO, MRT, true, FINAL>(p, c, f, gpc, media, avec, mean, out, gout, speed,
                                           {gring, mring}, fin);
}

// One cell of the brick kernel (row j of its brick).  One lattice streams
// straight into registers.  Two lattices go in two phases: first each
// lattice's streamed values (the bounce-back's global reads of a lattice
// issued together) go back to the cell's own slots; then T = Σg and f's
// moments, and each lattice in turn read from its slots, collided and
// stored, on a loop that is not unrolled: at most one lattice's q values
// are live, and the collision's code (the MRT rows unrolled) is there
// once.  FINAL (one lattice): the final form's stores too.
template <int Q, typename T, bool TWO, bool MRT, bool HALO = false, bool FINAL = false>
__device__ __forceinline__ void brick_cell(const LbmPlan& p, Stage<T> st, const T* msm, Cell c,
                                           int j, const T* __restrict__ fpc,
                                           const T* __restrict__ gpc,
                                           const int8_t* __restrict__ media,
                                           const T* __restrict__ avec,
                                           const T* __restrict__ mean, T* __restrict__ out,
                                           T* __restrict__ gout, T* __restrict__ speed,
                                           Ring<T> fr = {nullptr, nullptr},
                                           Ring<T> gr = {nullptr, nullptr}, Final<T> fin = {}) {
  static_assert(!(FINAL && (TWO || HALO)), "the final form takes one lattice, unsharded");
  constexpr int S = kMsmStride<Q, T>;
  const LbmCoef<T>& k = coef<T>();
  const long long N = p.nx * p.ny * p.nz;
  const int at = cell_index(p, c);
  const bool solid = st.media && st.m(0, j, 0, c.z) == 0;
  T temp = T(0);
  T f[Q];
  if constexpr (TWO) {
    settle<Q, T, HALO>(p, p.lat[1], st, 1, gpc, media, avec, N, c, j, gr);
    settle<Q, T, HALO>(p, p.lat[0], st, 0, fpc, media, avec, N, c, j, fr);
    forget();
    T g[Q];
    settled<Q, T>(st, 1, j, c.z, g);
    temp = g[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) temp = temp + g[q];
    forget();
    settled<Q, T>(st, 0, j, c.z, f);
  } else {
    brick_lattice<Q, T, HALO>(p, p.lat[0], st, 0, fpc, media, avec, N, c, j, f, fr);
  }
  const Flow<T> fl = flow<Q, T>(p, f, temp, solid);
  speed[at] = carried(p, fl, temp);
  if constexpr (FINAL) store_final<Q, T>(fin, f, fl, solid, N, at);
  if (!p.collide) {
#pragma unroll
    for (int q = 0; q < Q; ++q) out[q * N + at] = f[q];
    return;
  }
  const T third = T(0.5) * fl.usqr * k.inv_cs2;
  if constexpr (!TWO) {
    collide<Q, T, MRT, S, FINAL>(p, 0, f, fl.rho, fl.ux, fl.uy, fl.uz, third, solid,
                                 p.guo != 0, fl.rho, fl.Fx, fl.Fy, fl.Fz, mean, msm, out, N, at,
                                 fin.feq);
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
// HALO: the form of a block of a mesh, its halos from fring and mring
// (built for one lattice only; the unsharded form ignores the rings).
// FINAL: the final form of an unsharded one-lattice plan, which also
// stores fin (the last substep of a step; a compile-time form, so that the
// hot form's code stays as it was).
template <int Q, typename T, bool TWO, bool MRT, bool HALO = false, bool FINAL = false>
__global__ void __launch_bounds__((kBrickThreads<Q, TWO>), (kBrickBlocks<Q, TWO, MRT>))
lbm_brick_kernel(const T* __restrict__ fpc, const T* __restrict__ gpc,
                 const int8_t* __restrict__ media, const T* __restrict__ avec,
                 const T* __restrict__ mean, T* __restrict__ out, T* __restrict__ gout,
                 T* __restrict__ speed, const T* __restrict__ fring,
                 const T* __restrict__ gring, const int8_t* __restrict__ mring,
                 Final<T> fin) {
  static_assert(!(HALO && TWO), "the halo brick takes one lattice");
  extern __shared__ __align__(16) unsigned char smem[];
  const LbmPlan& p = c_plan;
  const int nz = (int)p.nz, by = p.brick.by;
  const BrickLayout lay = brick_layout(Q, sizeof(T), TWO ? 2 : 1, media != nullptr, MRT, by,
                                       p.brick.stages, nz);
  const T* msm = MRT ? brick_msm<Q, T, TWO>(smem + lay.msm_off) : nullptr;
  const BrickPipe pipe = brick_pipe(p, lay, smem);
  if (threadIdx.x < 32) {
    brick_produce<Q, T, true, HALO>(p, pipe, lay.lattice_bytes, lay.media_off, fpc,
                                    TWO ? gpc : nullptr, media, {fring, mring});
    return;
  }
  long long k = 0;
  for (long long b = blockIdx.x; b < pipe.bricks; b += gridDim.x, ++k) {
    const Stage<T> st = stage_at<T>(brick_acquire(pipe, k), lay.lattice_bytes, lay.media_off,
                                    TWO, media != nullptr, by, nz);
    const Brick br = brick_at(p, b);
    for (int i = threadIdx.x - 32; i < br.rows * nz; i += blockDim.x - 32) {
      const int j = i / nz;
      brick_cell<Q, T, TWO, MRT, HALO, FINAL>(p, st, msm, Cell{br.x, br.y0 + j, i - j * nz}, j,
                                              fpc, gpc, media, avec, mean, out, gout, speed,
                                              {fring, mring}, {gring, mring}, fin);
    }
    brick_release(pipe, k);
  }
}

// -- the Smagorinsky mean density inside the plane kernel -----------------------
//
// computes/lbm.py tree_mean: the streamed densities in flattened order,
// zero-padded to a power of two, summed in adjacent pairs level by level.
// Any sum over an aligned run of 2^k cells is one node of that tree.  The
// plane kernel's block b takes cells b·256 + k·grid·256 + t (t its
// thread): for each k an aligned run of 256, which the block sums in
// adjacent pairs in shared memory once its threads have streamed them all;
// every block then finishes the same tree over these chunk sums (a
// thread's aligned run of them as a binary counter carries, then the
// block's tree; above PLANE_FINAL of them the blocks first sum aligned
// runs of 256 of them, behind a second barrier): the eager chain's bits,
// in every block, with no atomics.
#define PLANE_CHUNK 256

// Threads of a plane block (one chunk) and the blocks an SM its registers
// leave room for: five in float with one lattice (at most 51 registers;
// the flat kernel needs 44), so that the 660 resident blocks of the card
// hold a thread for each of the 160,000 cells of 800x200; two otherwise.
// lbm_fused plane_blocks mirrors them.
constexpr int kPlaneThreads = PLANE_CHUNK;
template <typename T, bool TWO>
constexpr int kPlaneBlocks = (sizeof(T) == 4 && !TWO) ? 5 : 2;

// The tree over PLANE_CHUNK values, one a thread (every thread of the
// block calls it): adjacent pairs within each warp by shuffles (lane l
// adds lane l + d at level d), then the eight warps' sums in adjacent
// pairs out of `s`; every thread gets the root.
template <typename T>
__device__ __forceinline__ T block_tree(T v, T* s) {
  static_assert(PLANE_CHUNK == 256, "eight warps");
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const T o = __shfl_down_sync(0xffffffffu, v, d);
    if ((lane & (2 * d - 1)) == 0) v = v + o;
  }
  if (lane == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  const T root = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
  __syncthreads();
  return root;
}

// The tree over the m values of `v`, zero-padded to a power of two, in
// every block: each thread's aligned run of them eight at a time (the
// eight loads in flight together, summed as the aligned subtree they
// are), the groups merged as a binary counter carries, then the block's
// tree.  Reads skip L1: other SMs wrote them.
template <typename T>
__device__ __forceinline__ T tree_of(const T* v, long long m, T* s) {
  constexpr int G = 8;
  long long m2 = 1;
  while (m2 < m) m2 <<= 1;
  const long long run = m2 > PLANE_CHUNK ? m2 / PLANE_CHUNK : 1;
  const int width = run < G ? (int)run : G;  // a group: run < G only as one group
  T stack[48];
  int depth = 0;
  for (long long g = 0; g < run / width; ++g) {
    T x8[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const long long j = threadIdx.x * run + g * width + u;
      x8[u] = u < width && j < m ? __ldcg(v + j) : T(0);
    }
    // the aligned subtree of the group's `width` values (1, 2, 4 or 8)
    T x = x8[0];
    if (width == 2) x = x8[0] + x8[1];
    if (width == 4) x = (x8[0] + x8[1]) + (x8[2] + x8[3]);
    if (width == 8) x = ((x8[0] + x8[1]) + (x8[2] + x8[3])) + ((x8[4] + x8[5]) + (x8[6] + x8[7]));
    for (long long b = g; b & 1; b >>= 1) x = stack[--depth] + x;
    stack[depth++] = x;
  }
  return block_tree(stack[0], s);
}

// Chunk sums a block reads for the mean at most; above it the blocks first
// sum them in aligned runs of PLANE_CHUNK, behind a second barrier.
#define PLANE_FINAL 2048

// The plane kernel of 2-D Smagorinsky plans (D2Q9, nz = 1): the flat map,
// one thread a cell of the flattened grid, on a cooperative launch (every
// block resident) so that a grid-wide barrier is legal.  Each thread takes
// cells first, first + grid·blockDim, ...  A first pass streams each of
// its cells through lattice 1's faces; the first cell's streamed lattice
// and density wait in registers (at 800x200 the resident threads
// outnumber the cells, so every cell waits), the other cells' densities in
// scratch[0, N).  The block then sums each of its aligned runs into
// scratch[N + run]; a barrier (two above PLANE_FINAL runs); the mean in
// every block (block 0 also writes it to mean_out); then each cell's
// update, its lattice out of the registers or streamed again.
template <typename T, bool TWO, bool MRT>
__global__ void __launch_bounds__(kPlaneThreads, (kPlaneBlocks<T, TWO>))
lbm_plane_kernel(const T* __restrict__ fpc, const T* __restrict__ gpc,
                 const int8_t* __restrict__ media, const T* __restrict__ avec,
                 T* __restrict__ scratch, T* __restrict__ mean_out, T* __restrict__ out,
                 T* __restrict__ gout, T* __restrict__ speed) {
  constexpr int Q = 9;
  const LbmPlan& p = c_plan;
  __shared__ T red[PLANE_CHUNK / 32];
  const int ny = (int)p.ny;
  const long long N = p.nx * p.ny;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  T* partial = scratch + N;
  T held[Q];
  T rho_first = T(0);
  for (long long i = first; i < N; i += step) {
    const Cell c = {(int)(i / ny), (int)(i % ny), 0};
    T f[Q];
    load_lattice<Q, T, false>(p, p.lat[0], fpc, media, avec, N, c, f);
    T rho = f[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) rho = rho + f[q];
    if (i == first) {
      rho_first = rho;
#pragma unroll
      for (int q = 0; q < Q; ++q) held[q] = f[q];
    } else {
      scratch[i] = rho;
    }
  }
  __syncthreads();  // the block's densities, for its own runs
  // each run's sum, the next run's densities loaded while it is summed
  T v = rho_first;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < N; base += step) {
    const long long next = base + step + threadIdx.x;
    const T ahead = next < N ? scratch[next] : T(0);
    const T sum = block_tree(v, red);
    if (threadIdx.x == 0) partial[base / PLANE_CHUNK] = sum;
    v = ahead;
  }
  __threadfence();
  cooperative_groups::this_grid().sync();
  const T* sums = partial;
  long long m = (N + PLANE_CHUNK - 1) / PLANE_CHUNK;
  if (m > PLANE_FINAL) {
    // the next level of the tree, spread over the blocks
    T* second = partial + m;
    for (long long g = blockIdx.x; g * PLANE_CHUNK < m; g += gridDim.x) {
      const long long j = g * PLANE_CHUNK + threadIdx.x;
      const T sum = block_tree(j < m ? __ldcg(partial + j) : T(0), red);
      if (threadIdx.x == 0) second[g] = sum;
    }
    __threadfence();
    cooperative_groups::this_grid().sync();
    sums = second;
    m = (m + PLANE_CHUNK - 1) / PLANE_CHUNK;
  }
  const T mean = tree_of(sums, m, red) * (T)(1.0 / (double)N);
  if (first == 0 && mean_out) *mean_out = mean;
  for (long long i = first; i < N; i += step) {
    const Cell c = {(int)(i / ny), (int)(i % ny), 0};
    T f[Q];
    if (i == first) {
#pragma unroll
      for (int q = 0; q < Q; ++q) f[q] = held[q];
    } else {
      load_lattice<Q, T, false>(p, p.lat[0], fpc, media, avec, N, c, f);
    }
    flat_update<Q, T, TWO, MRT, false>(p, c, f, gpc, media, avec, &mean, out, gout, speed);
  }
}

// The plan into constant memory on `stream`, unless the last copy of this
// library on this device was the same plan on the same stream: the
// launches of a fused loop share one plan and find it there (a copy from
// pageable memory a launch cost more than a 2-D kernel at 800x200).
// Launches on one stream run in order, so the copy has landed before any
// later one reads it; another stream's plan, or another plan, is copied
// again.  That record holds only for launches on live streams: a launch
// on a stream being captured into a CUDA graph always copies (the graph
// then carries its own copy), and once a capture has been seen no launch
// trusts the record again, since a graph's replay rewrites the plan where
// the record cannot see it.  (A plan read from device memory, as a
// pointer would give it, needs no record but ran the kernels 3-49%
// slower than constant memory, PERF.md.)
cudaError_t copy_plan(const LbmPlan& p, cudaStream_t stream) {
  struct Copied {
    bool valid;
    int dev;
    cudaStream_t stream;
    LbmPlan plan;
  };
  static Copied last[8];
  static bool captured = false;
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaError_t err = cudaStreamIsCapturing(stream, &status);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusNone) captured = true;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Copied& c = last[dev & 7];
  if (!captured && c.valid && c.dev == dev && c.stream == stream &&
      !memcmp(&c.plan, &p, sizeof(LbmPlan)))
    return cudaSuccess;
  c.valid = false;
  err = cudaMemcpyToSymbolAsync(c_plan, &p, sizeof(LbmPlan), 0, cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return err;
  c.dev = dev;
  c.stream = stream;
  c.plan = p;
  c.valid = true;
  return cudaSuccess;
}

// The final form's outputs as the C entry takes them (Final's pointers).
struct LbmStores {
  void* f;
  void* feq;
  void* rho;
  void* vel;
};

template <typename T>
Final<T> typed(const LbmStores& s) {
  return {(T*)s.f, (T*)s.feq, (T*)s.rho, (T*)s.vel};
}

template <int Q, typename T, bool TWO, bool MRT, bool FINAL = false>
cudaError_t launch(const void* fpc, const void* gpc, const void* media, const void* avec,
                   const void* mean, void* out, void* gout, void* speed, const void* const* rings,
                   const LbmPlan& p, cudaStream_t stream, const LbmStores& stores = {}) {
  // one thread a cell: x and y from the grid, z along the block; a 2-D
  // plan over the flattened grid
  const bool flat = p.nz == 1;
  const int threads = flat || p.nz >= 256 ? 256 : (int)((p.nz + 31) / 32 * 32);
  const dim3 grid = flat ? dim3((unsigned)((p.nx * p.ny + threads - 1) / threads))
                         : dim3((unsigned)((p.nz + threads - 1) / threads),
                                (unsigned)p.ny, (unsigned)p.nx);
  cudaError_t err = copy_plan(p, stream);
  if (err != cudaSuccess) return err;
  lbm_substep_kernel<Q, T, TWO, MRT, FINAL><<<grid, threads, 0, stream>>>(
      (const T*)fpc, (const T*)gpc, (const int8_t*)media, (const T*)avec, (const T*)mean,
      (T*)out, (T*)gout, (T*)speed, flat, (const T*)rings[0], (const T*)rings[1],
      (const int8_t*)rings[2], typed<T>(stores));
  return cudaGetLastError();
}

// The brick plan against what the brick kernel takes: a 3-D plan, rows of
// 16-byte multiples (media rows too; on a block of a mesh each ring row
// starts at a multiple of nz, so a ring's stride must be one), a producer
// and at least one consumer warp, and the shared memory brick_layout
// gives, within the 227 KB a block may have.
template <int Q, typename T>
bool brick_ok(const LbmPlan& p, bool media) {
  const LbmBrick& b = p.brick;
  if (Q == 9 || p.nz == 1 || b.by < 1 || b.stages < 1 || b.threads < 64 ||
      b.threads > (p.two_lattice ? kBrickThreads<Q, true> : kBrickThreads<Q, false>) ||
      b.threads % 32 || (p.nz * (long long)sizeof(T)) % 16 ||
      (media && p.nz % 16) || (p.halo.on && p.halo.stride % p.nz))
    return false;
  const bool mrt = p.mrt[0] || (p.two_lattice && p.mrt[1]);
  const BrickLayout l = brick_layout(Q, sizeof(T), p.two_lattice ? 2 : 1, media, mrt, b.by,
                                     b.stages, p.nz);
  return l.smem == b.smem && l.smem <= 232448;
}

// The cooperative launch against what the plane kernel takes: a 2-D
// Smagorinsky plan, the block it is built for, a grid.
bool plane_ok(const LbmPlan& p) {
  const LbmBrick& b = p.brick;
  return p.nz == 1 && p.smag && b.by == 0 && b.threads == kPlaneThreads && b.grid >= 1;
}

// Blocks resident on the card at once at this block shape, cached by
// device, shared memory and threads; the shared-memory limit is raised on
// the first launch of each.
struct Resident {
  int dev = -1, smem = 0, threads = 0, blocks = 0;
};

template <typename K>
cudaError_t resident(Resident& r, K kernel, const LbmBrick& b) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (r.dev == dev && r.smem == b.smem && r.threads == b.threads))
    return err;
  int per_sm = 0, sms = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, b.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, b.threads, b.smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  r = {dev, b.smem, b.threads, per_sm * sms};
  return cudaSuccess;
}

template <int Q, typename T, bool TWO, bool MRT, bool HALO, bool FINAL = false>
cudaError_t launch_brick(const void* fpc, const void* gpc, const void* media, const void* avec,
                         const void* mean, void* out, void* gout, void* speed,
                         const void* const* rings, const LbmPlan& p, cudaStream_t stream,
                         const LbmStores& stores = {}) {
  static Resident r;
  auto kernel = lbm_brick_kernel<Q, T, TWO, MRT, HALO, FINAL>;
  const LbmBrick& b = p.brick;
  cudaError_t err = resident(r, kernel, b);
  if (err != cudaSuccess) return err;
  const long long bricks = p.nx * ((p.ny + b.by - 1) / b.by);
  err = copy_plan(p, stream);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bricks < r.blocks ? bricks : r.blocks), b.threads, b.smem, stream>>>(
      (const T*)fpc, (const T*)gpc, (const int8_t*)media, (const T*)avec, (const T*)mean,
      (T*)out, (T*)gout, (T*)speed, (const T*)rings[0], (const T*)rings[1],
      (const int8_t*)rings[2], typed<T>(stores));
  return cudaGetLastError();
}

// The plane kernel on the plan's grid, a cooperative launch (the
// grid-wide barriers need every block resident: a grid the card cannot
// hold is an error, never a smaller grid).
template <typename T, bool TWO, bool MRT>
cudaError_t launch_plane(const void* fpc, const void* gpc, const void* media, const void* avec,
                         void* scratch, void* mean, void* out, void* gout, void* speed,
                         const LbmPlan& p, cudaStream_t stream) {
  static Resident r;
  auto kernel = lbm_plane_kernel<T, TWO, MRT>;
  const LbmBrick& b = p.brick;
  cudaError_t err = resident(r, kernel, b);
  if (err != cudaSuccess) return err;
  if (b.grid > r.blocks) return cudaErrorCooperativeLaunchTooLarge;
  err = copy_plan(p, stream);
  if (err != cudaSuccess) return err;
  const T* a_fpc = (const T*)fpc;
  const T* a_gpc = (const T*)gpc;
  const int8_t* a_media = (const int8_t*)media;
  const T* a_avec = (const T*)avec;
  T* a_scratch = (T*)scratch;
  T* a_mean = (T*)mean;
  T* a_out = (T*)out;
  T* a_gout = (T*)gout;
  T* a_speed = (T*)speed;
  void* args[] = {&a_fpc, &a_gpc, &a_media, &a_avec, &a_scratch,
                  &a_mean, &a_out, &a_gout, &a_speed};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)b.grid),
                                     dim3((unsigned)b.threads), args, 0, stream);
}

// The plane kernel on a plan with its cooperative grid; the brick kernel
// where the plan has a brick walk (and the buffers are 16-byte aligned, as
// the bulk copies need: torch's allocations are); the flat kernel
// otherwise.  All give the same bits.  A block of a mesh with a brick walk
// takes the halo brick, one lattice only, its rings aligned too: anything
// else is an error, never a flat launch.
template <int Q, typename T, bool TWO, bool MRT>
cudaError_t launch_any(const void* fpc, const void* gpc, const void* media, const void* avec,
                       void* scratch, void* mean, void* out, void* gout, void* speed,
                       const void* const* rings, const LbmPlan& p, cudaStream_t stream) {
  if constexpr (Q == 9) {
    if (p.brick.grid > 0) {
      if (!scratch) return cudaErrorInvalidValue;
      return launch_plane<T, TWO, MRT>(fpc, gpc, media, avec, scratch, mean, out, gout, speed,
                                       p, stream);
    }
  } else {
    const bool aligned = (((uintptr_t)fpc | (uintptr_t)gpc | (uintptr_t)media) & 15) == 0;
    if (p.brick.by > 0 && p.halo.on) {
      if constexpr (TWO) {
        return cudaErrorInvalidValue;
      } else {
        if (!aligned || (((uintptr_t)rings[0] | (uintptr_t)rings[2]) & 15))
          return cudaErrorInvalidValue;
        return launch_brick<Q, T, false, MRT, true>(fpc, gpc, media, avec, mean, out, gout,
                                                    speed, rings, p, stream);
      }
    }
    if (p.brick.by > 0 && aligned)
      return launch_brick<Q, T, TWO, MRT, false>(fpc, gpc, media, avec, mean, out, gout, speed,
                                                 rings, p, stream);
  }
  if (p.smag && !mean) return cudaErrorInvalidValue;
  return launch<Q, T, TWO, MRT>(fpc, gpc, media, avec, mean, out, gout, speed, rings, p,
                                stream);
}

template <int Q, typename T>
cudaError_t dispatch(const void* fpc, const void* gpc, const void* media, const void* avec,
                     void* scratch, void* mean, void* out, void* gout, void* speed,
                     const void* const* rings, const LbmPlan& p, cudaStream_t stream) {
  if ((p.brick.grid > 0 && !(Q == 9 && plane_ok(p))) ||
      (p.brick.by > 0 && !brick_ok<Q, T>(p, media != nullptr)))
    return cudaErrorInvalidValue;
  // a block of a mesh takes the flat kernel or, with one lattice, the halo
  // brick, with its rings; never the plane kernel
  if (p.halo.on && (p.brick.grid > 0 || (p.brick.by > 0 && p.two_lattice) || !rings[0] ||
                    (p.two_lattice && !rings[1]) || (media && !rings[2])))
    return cudaErrorInvalidValue;
  const bool mrt = p.mrt[0] || (p.two_lattice && p.mrt[1]);
#define LBM_LAUNCH(TWO, MRT)                                                                  \
  launch_any<Q, T, TWO, MRT>(fpc, gpc, media, avec, scratch, mean, out, gout, speed, rings, p, \
                             stream)
  if (p.two_lattice) return mrt ? LBM_LAUNCH(true, true) : LBM_LAUNCH(true, false);
  return mrt ? LBM_LAUNCH(false, true) : LBM_LAUNCH(false, false);
#undef LBM_LAUNCH
}

// The final form: an unsharded one-lattice 3-D plan with a collision (no
// Smagorinsky, no plane walk) on the brick where launch_any would take it,
// else on the flat kernel, each also storing `stores`.  Instantiated for
// Q = 19, 27 only, so the 2-D and two-lattice kernels build as before.
template <int Q, typename T>
cudaError_t dispatch_final(const void* fpc, const void* media, const void* avec, void* out,
                           void* speed, const LbmStores& stores, const LbmPlan& p,
                           cudaStream_t stream) {
  if (p.two_lattice || p.halo.on || !p.collide || p.smag || p.two_d || p.brick.grid > 0 ||
      (p.brick.by > 0 && !brick_ok<Q, T>(p, media != nullptr)))
    return cudaErrorInvalidValue;
  const void* rings[3] = {nullptr, nullptr, nullptr};
  const bool aligned = (((uintptr_t)fpc | (uintptr_t)media) & 15) == 0;
#define LBM_FINAL(MRT)                                                                    \
  (p.brick.by > 0 && aligned                                                              \
       ? launch_brick<Q, T, false, MRT, false, true>(fpc, nullptr, media, avec, nullptr, \
                                                     out, nullptr, speed, rings, p,      \
                                                     stream, stores)                     \
       : launch<Q, T, false, MRT, true>(fpc, nullptr, media, avec, nullptr, out, nullptr, \
                                        speed, rings, p, stream, stores))
  return p.mrt[0] ? LBM_FINAL(true) : LBM_FINAL(false);
#undef LBM_FINAL
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

// The plan checks: the per-lattice limits, the perturbed rows' table,
// 32-bit cell indices, and the grid's y and z extents of a 3-D launch (at
// most 65535).
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
// inlets, or null; speed: (nx, ny, nz); float32, or float64 where
// is_double.  On Smagorinsky plans the plane kernel (a 2-D plan with its
// cooperative grid) computes the mean density itself in `scratch` (nx ny +
// m + ceil(m / 256) values, m = ceil(nx ny / 256)), and writes it to
// `mean` (one value) unless null; the flat kernel reads the mean from
// `mean`.  `plan` is a host
// pointer, copied to constant memory on `stream` where it is not there
// already.  On a block of a mesh (plan->halo.on) fring, gring (on
// two-lattice plans) and mring (on media plans) are the halo rings, (q, H)
// and (H) with H = plan->halo.stride; null otherwise.
extern "C" cudaError_t mtt_lbm_substep(const void* fpc, const void* gpc, const void* media,
                                       const void* avec, void* mean, void* scratch, void* out,
                                       void* gout, void* speed, const void* fring,
                                       const void* gring, const void* mring, int q,
                                       int is_double, const LbmPlan* plan,
                                       cudaStream_t stream) {
  const LbmPlan& p = *plan;
  if (!plan_ok(p, avec) || (p.two_lattice && (!gpc || !gout))) return cudaErrorInvalidValue;
  const void* rings[3] = {fring, gring, mring};
#define LBM_DISPATCH(Q)                                                                 \
  return is_double ? dispatch<Q, double>(fpc, gpc, media, avec, scratch, mean, out, gout, \
                                         speed, rings, p, stream)                        \
                   : dispatch<Q, float>(fpc, gpc, media, avec, scratch, mean, out, gout,  \
                                        speed, rings, p, stream)
  if (q == 9) LBM_DISPATCH(9);
  if (q == 19) LBM_DISPATCH(19);
  if (q == 27) LBM_DISPATCH(27);
#undef LBM_DISPATCH
  return cudaErrorInvalidValue;
}

// The final form of a substep (the last of a step): mtt_lbm_substep's
// one-lattice launch, which also stores the streamed distribution after
// its faces (f) and each direction's equilibrium (feq), (q, nx, ny, nz),
// the density (nx, ny, nz) and the velocity (nx, ny, nz, 3), solids zero.
// q = 19 or 27; an unsharded 3-D plan with a collision, else
// cudaErrorInvalidValue.
extern "C" cudaError_t mtt_lbm_final(const void* fpc, const void* media, const void* avec,
                                     void* out, void* speed, void* f, void* feq, void* rho,
                                     void* vel, int q, int is_double, const LbmPlan* plan,
                                     cudaStream_t stream) {
  const LbmPlan& p = *plan;
  if (!plan_ok(p, avec) || !f || !feq || !rho || !vel) return cudaErrorInvalidValue;
  const LbmStores stores = {f, feq, rho, vel};
#define LBM_DISPATCH(Q)                                                                   \
  return is_double ? dispatch_final<Q, double>(fpc, media, avec, out, speed, stores, p,   \
                                               stream)                                   \
                   : dispatch_final<Q, float>(fpc, media, avec, out, speed, stores, p, stream)
  if (q == 19) LBM_DISPATCH(19);
  if (q == 27) LBM_DISPATCH(27);
#undef LBM_DISPATCH
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
// size, then the offsets of lat, lat[1], d, d.msm, f, f.msm, brick, halo.
extern "C" int mtt_lbm_plan_layout(int64_t* out) {
  out[0] = (int64_t)sizeof(LbmPlan);
  out[1] = (int64_t)offsetof(LbmPlan, lat);
  out[2] = (int64_t)(offsetof(LbmPlan, lat) + sizeof(LbmFaces));
  out[3] = (int64_t)offsetof(LbmPlan, d);
  out[4] = (int64_t)(offsetof(LbmPlan, d) + offsetof(LbmCoef<double>, msm));
  out[5] = (int64_t)offsetof(LbmPlan, f);
  out[6] = (int64_t)(offsetof(LbmPlan, f) + offsetof(LbmCoef<float>, msm));
  out[7] = (int64_t)offsetof(LbmPlan, brick);
  out[8] = (int64_t)offsetof(LbmPlan, halo);
  return 0;
}
