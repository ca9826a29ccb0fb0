// Stripped variants of kernel 7 (lbm_substep.cu), for diagnosis only
// (marlin_tpu_torch/lbm_probe.py); no solver path launches them.
//
//   mode 0, copy only: each lattice's q planes read and written at the
//           cell itself, no shift;
//   mode 1, stream only: the pull reads at the shifted source and the
//           stores, with no media, faces or collision;
//   mode 2, stream + media/bounce: mode 1 with face and obstacle
//           bounce-back and solid masking (no post-stream faces, moments
//           or collision).
//
// Each mode is given on the flat one-thread-a-cell map (3-D and 2-D plans)
// and on the brick map of the shipped kernel (3-D plans).  The variants are built from the shipped
// kernels' own pieces (stream_cell, the brick walk and its stage), with
// the same block shape and shared memory, so they change with them.  The
// whole kernels are the shipped ones (mtt_lbm_substep with a flat or a
// brick plan).

#include "lbm_substep.cuh"

namespace {

// One lattice's q values of cell c in the variant's way.
template <int Q, typename T, int MODE>
__device__ __forceinline__ void flat_values(const LbmPlan& p, const LbmFaces& L,
                                            const T* __restrict__ fpc,
                                            const int8_t* __restrict__ media, long long N,
                                            Cell c, T (&f)[Q]) {
  using D = Lattice<Q>;
  if (MODE == 2) {
    stream_cell<Q, T>(p, L, fpc, media, N, c, f);
    return;
  }
  const int ny = (int)p.ny, nz = (int)p.nz;
  const Around xs(c.x, (int)p.nx), ys(c.y, ny), zs(c.z, nz);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int src = MODE == 0 ? cell_index(p, c)
                              : (xs.v[1 - D::ex(q)] * ny + ys.v[1 - D::ey(q)]) * nz +
                                    zs.v[1 - D::ez(q)];
    f[q] = fpc[q * N + src];
  }
}

// The flat kernel's map (x and y from the grid, z along the block; on a
// 2-D plan the flattened grid); both lattices are read before either is
// written, as the shipped kernel does.
template <int Q, typename T, bool TWO, int MODE>
__global__ void __launch_bounds__(256)
flat_probe(const T* __restrict__ fpc, const T* __restrict__ gpc,
           const int8_t* __restrict__ media, T* __restrict__ out, T* __restrict__ gout) {
  const LbmPlan& p = c_plan;
  Cell c;
  if (!thread_cell(p, p.nz == 1, c)) return;
  const long long N = p.nx * p.ny * p.nz;
  const int at = cell_index(p, c);
  T f[Q];
  flat_values<Q, T, MODE>(p, p.lat[0], fpc, media, N, c, f);
  T g[TWO ? Q : 1];
  if constexpr (TWO) flat_values<Q, T, MODE>(p, p.lat[1], gpc, media, N, c, g);
#pragma unroll
  for (int q = 0; q < Q; ++q) out[q * N + at] = f[q];
  if constexpr (TWO) {
#pragma unroll
    for (int q = 0; q < Q; ++q) gout[q * N + at] = g[q];
  }
}

template <int Q, typename T, bool TWO, int MODE>
cudaError_t launch_flat(const void* fpc, const void* gpc, const void* media, void* out,
                        void* gout, const LbmPlan& p, cudaStream_t stream) {
  const bool flat = p.nz == 1;
  const int threads = flat || p.nz >= 256 ? 256 : (int)((p.nz + 31) / 32 * 32);
  const dim3 grid = flat ? dim3((unsigned)((p.nx * p.ny + threads - 1) / threads))
                         : dim3((unsigned)((p.nz + threads - 1) / threads), (unsigned)p.ny,
                                (unsigned)p.nx);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_plan, &p, sizeof(LbmPlan), 0,
                                            cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return err;
  flat_probe<Q, T, TWO, MODE><<<grid, threads, 0, stream>>>(
      (const T*)fpc, (const T*)gpc, (const int8_t*)media, (T*)out, (T*)gout);
  return cudaGetLastError();
}

// The brick kernel's pipeline and map with the variant's work a cell: its
// stage holds the media rows only in mode 2, and (mode 0) the unshifted
// rows.
template <int Q, typename T, bool TWO, int MODE>
__global__ void __launch_bounds__((kBrickThreads<Q, TWO>), (kBrickBlocks<Q, TWO, false>))
brick_probe(const T* __restrict__ fpc, const T* __restrict__ gpc,
            const int8_t* __restrict__ media, T* __restrict__ out, T* __restrict__ gout) {
  using D = Lattice<Q>;
  extern __shared__ __align__(16) unsigned char smem[];
  const LbmPlan& p = c_plan;
  const long long N = p.nx * p.ny * p.nz;
  const int nz = (int)p.nz, by = p.brick.by;
  const int8_t* m = MODE == 2 ? media : nullptr;
  const BrickLayout lay = brick_layout(Q, sizeof(T), TWO ? 2 : 1, m != nullptr, false, by,
                                       p.brick.stages, nz);
  const BrickPipe pipe = brick_pipe(p, lay, smem);
  if (threadIdx.x < 32) {
    brick_produce<Q, T, MODE != 0>(p, pipe, lay.lattice_bytes, lay.media_off, fpc,
                                   TWO ? gpc : nullptr, m);
    return;
  }
  long long k = 0;
  for (long long b = blockIdx.x; b < pipe.bricks; b += gridDim.x, ++k) {
    const Stage<T> st = stage_at<T>(brick_acquire(pipe, k), lay.lattice_bytes, lay.media_off,
                                    TWO, m != nullptr, by, nz);
    const Brick br = brick_at(p, b);
    for (int i = threadIdx.x - 32; i < br.rows * nz; i += blockDim.x - 32) {
      const int j = i / nz;
      const Cell c = {br.x, br.y0 + j, i - j * nz};
      const int at = cell_index(p, c);
      const Around zs(c.z, nz);
#pragma unroll
      for (int l = 0; l < (TWO ? 2 : 1); ++l) {
        T f[Q];
        if (MODE == 2) {
          brick_stream<Q, T>(p, p.lat[l], st, l, l ? gpc : fpc, N, c, j, f);
        } else {
#pragma unroll
          for (int q = 0; q < Q; ++q)
            f[q] = st.row(l, q, j, MODE == 0 ? c.z : zs.v[1 - D::ez(q)]);
        }
        T* o = l ? gout : out;
#pragma unroll
        for (int q = 0; q < Q; ++q) o[q * N + at] = f[q];
      }
    }
    brick_release(pipe, k);
  }
}

template <int Q, typename T, bool TWO, int MODE>
cudaError_t launch_brick_probe(const void* fpc, const void* gpc, const void* media, void* out,
                               void* gout, const LbmPlan& p, cudaStream_t stream) {
  auto kernel = brick_probe<Q, T, TWO, MODE>;
  const LbmBrick& b = p.brick;
  const BrickLayout lay = brick_layout(Q, sizeof(T), TWO ? 2 : 1, MODE == 2 && media, false,
                                       b.by, b.stages, p.nz);
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)lay.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, b.threads,
                                                        (size_t)lay.smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_plan, &p, sizeof(LbmPlan), 0, cudaMemcpyHostToDevice,
                                  stream);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long bricks = p.nx * ((p.ny + b.by - 1) / b.by);
  const long long blocks = (long long)per_sm * sms;
  kernel<<<(unsigned)(bricks < blocks ? bricks : blocks), b.threads, (size_t)lay.smem,
           stream>>>((const T*)fpc, (const T*)gpc, (const int8_t*)media, (T*)out, (T*)gout);
  return cudaGetLastError();
}

template <int Q, typename T, bool TWO>
cudaError_t by_mode_brick(int mode, const void* fpc, const void* gpc, const void* media,
                          void* out, void* gout, const LbmPlan& p, cudaStream_t stream) {
  if (mode == 0) return launch_brick_probe<Q, T, TWO, 0>(fpc, gpc, media, out, gout, p, stream);
  if (mode == 1) return launch_brick_probe<Q, T, TWO, 1>(fpc, gpc, media, out, gout, p, stream);
  if (mode == 2) return launch_brick_probe<Q, T, TWO, 2>(fpc, gpc, media, out, gout, p, stream);
  return cudaErrorInvalidValue;
}

template <int Q, typename T, bool TWO>
cudaError_t by_mode(int mode, const void* fpc, const void* gpc, const void* media, void* out,
                    void* gout, const LbmPlan& p, cudaStream_t stream) {
  if (mode == 0) return launch_flat<Q, T, TWO, 0>(fpc, gpc, media, out, gout, p, stream);
  if (mode == 1) return launch_flat<Q, T, TWO, 1>(fpc, gpc, media, out, gout, p, stream);
  if (mode == 2) return launch_flat<Q, T, TWO, 2>(fpc, gpc, media, out, gout, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// fpc, out (and gpc, gout on two-lattice plans): (q, nx, ny, nz) float32;
// media: (nx, ny, nz) int8 or null; mode 0, 1 or 2 (above) on the flat
// map (on a 2-D plan, nz = 1, one thread a cell of the flattened grid).
// Only the float32 stencils the decks use: q = 9, 19 and 27.
extern "C" cudaError_t probe_lbm_flat(int mode, int q, const void* fpc, const void* gpc,
                                      const void* media, void* out, void* gout,
                                      const LbmPlan* plan, cudaStream_t stream) {
  const LbmPlan& p = *plan;
  if (p.nz != 1 && (p.nx > 65535 || p.ny > 65535)) return cudaErrorInvalidValue;
  if (p.two_lattice && (!gpc || !gout)) return cudaErrorInvalidValue;
#define PROBE(Q)                                                                          \
  return p.two_lattice                                                                    \
             ? by_mode<Q, float, true>(mode, fpc, gpc, media, out, gout, p, stream)       \
             : by_mode<Q, float, false>(mode, fpc, gpc, media, out, gout, p, stream)
  if (q == 9) PROBE(9);
  if (q == 19) PROBE(19);
  if (q == 27) PROBE(27);
#undef PROBE
  return cudaErrorInvalidValue;
}

// The same modes on the brick map of the plan's brick walk (by, stages,
// threads; its smem field is not read: a variant's stage holds only what
// it reads).
extern "C" cudaError_t probe_lbm_brick(int mode, int q, const void* fpc, const void* gpc,
                                       const void* media, void* out, void* gout,
                                       const LbmPlan* plan, cudaStream_t stream) {
  const LbmPlan& p = *plan;
  const LbmBrick& b = p.brick;
  const int most = q == 27 ? (p.two_lattice ? kBrickThreads<27, true> : kBrickThreads<27, false>)
                           : (p.two_lattice ? kBrickThreads<19, true> : kBrickThreads<19, false>);
  if (p.nz == 1 || b.by < 1 || b.stages < 1 || b.threads < 64 || b.threads > most ||
      b.threads % 32 || (p.nz * 4) % 16 || (mode == 2 && media && p.nz % 16))
    return cudaErrorInvalidValue;
  if (p.two_lattice && (!gpc || !gout)) return cudaErrorInvalidValue;
#define PROBE(Q)                                                                          \
  return p.two_lattice                                                                    \
             ? by_mode_brick<Q, float, true>(mode, fpc, gpc, media, out, gout, p, stream) \
             : by_mode_brick<Q, float, false>(mode, fpc, gpc, media, out, gout, p, stream)
  if (q == 19) PROBE(19);
  if (q == 27) PROBE(27);
#undef PROBE
  return cudaErrorInvalidValue;
}

