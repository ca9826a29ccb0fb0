// Stripped variants of the unordered-FFT kernels of fft_tile.cuh, for
// diagnosis only (marlin_tpu_torch/fft_probe.py); no solver path launches them.
//
//   mode 0, copy only: the kernel's global loads and stores with the same
//           tiling and permutation, no FFT stages;
//   mode 1, stages only: the FFT stages (and, for the shared-memory tile,
//           the permuted read-out) on data made from the thread index, no
//           global traffic (the tile stores only when `sink` is non-zero,
//           which the probe never passes, the register kernel only when a
//           sum of its results has a bit pattern they do not reach, so the
//           compiler keeps the work);
//   mode 2 (tile only): the tile kernel whole, which the register kernels
//           replace at n = 512;
//   mode 3 (register, inverse sublanes only): the shipped register kernel
//           whole on the other cluster size (clusters of 1 where it takes
//           8, of 8 where it takes 1).
//
// Modes 0 and 1 are given for the generic shared-memory tile (`tile_*`, at
// any extent the tile takes, forward only) and for the register kernels
// (`reg_*`, at n = 512, forward or inverse); `inverse` picks the direction
// (the inverse lanes variants write the real part, as the solver's last
// inverse does).  The small-extent kernels (`small_*`, any extent with b =
// n) have mode 0, copy only (the plan and input fetch, the widening to
// float64 and the epilogue's rounded store, no stages), and mode 1, the
// shipped kernel whole on `width` transforms a block (its rows or columns;
// 0 takes the launcher's own).  The variants are built from the shipped
// kernels' own pieces (the ring's fetch and read, reg_fft, reg_out, the
// small path's fetch and widening, the epilogues), with the same block
// shape and shared memory, so they change with them.

#include "fft_tile.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
tile_lanes_probe(const float* __restrict__ xr, const float2* __restrict__ xc,
                 float2* __restrict__ out, const float2* __restrict__ tw_g,
                 Plan p, int64_t B, int sink) {
  extern __shared__ float2 smem[];
  const int n = p.n, E = n * p.T;
  float2* a = smem;
  float2* c = smem + E;
  float2* tw = smem + 2 * E;
  const int64_t row0 = (int64_t)blockIdx.x * p.T;
  const int64_t base = row0 * n;
  load_table(tw, tw_g, n);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    float2 v = make_float2((float)i, (float)threadIdx.x);
    if (MODE == 0) {
      v = make_float2(0.f, 0.f);
      if (row0 + i / n < B) v = xr ? make_float2(xr[base + i], 0.f) : xc[base + i];
    }
    a[i] = v;
  }
  __syncthreads();
  const float2* res = MODE == 0 ? a : tile_fft<true, false>(a, c, tw, p);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i / n, kp = i % n;
    if (row0 + l < B && (MODE == 0 || sink))
      out[base + i] = res[l * n + true_k(kp, p)];
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
tile_sublanes_probe(const float* __restrict__ xr,
                    const float2* __restrict__ xc, float2* __restrict__ out,
                    const float2* __restrict__ tw_g, Plan p, int64_t L,
                    int sink) {
  extern __shared__ float2 smem[];
  const int n = p.n, T = p.T, E = n * T;
  float2* a = smem;
  float2* c = smem + E;
  float2* tw = smem + 2 * E;
  const int64_t base = (int64_t)blockIdx.y * n * L;
  const int64_t col0 = (int64_t)blockIdx.x * T;
  load_table(tw, tw_g, n);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i % T, k = i / T;
    const int64_t col = col0 + l;
    float2 v = make_float2((float)i, (float)threadIdx.x);
    if (MODE == 0) {
      v = make_float2(0.f, 0.f);
      if (col < L) {
        const int64_t g = base + (int64_t)k * L + col;
        v = xr ? make_float2(xr[g], 0.f) : xc[g];
      }
    }
    a[i] = v;
  }
  __syncthreads();
  const float2* res = MODE == 0 ? a : tile_fft<false, false>(a, c, tw, p);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i % T, kp = i / T;
    const int64_t col = col0 + l;
    if (col < L && (MODE == 0 || sink))
      out[base + (int64_t)kp * L + col] = res[true_k(kp, p) * T + l];
  }
}

// Keeps a stages-only variant's results alive: stored only when their sum
// has a bit pattern that sums of these inputs do not reach.
__device__ __forceinline__ bool never(float acc) {
  return __float_as_uint(acc) == 0x7fc0beefu;
}

// reg_lanes_kernel without its stages (MODE 0) or without its global
// traffic (MODE 1), in the direction of its epilogue.
template <int N, int MODE, class Epi>
__global__ void __launch_bounds__(kRegLanesThreads, 2)
reg_lanes_probe(const float* __restrict__ xr, const float2* __restrict__ xc,
                const float2* __restrict__ tw_g, int64_t B, int64_t tiles,
                Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
  constexpr int T = N / 8, G = kRegLanesThreads / T, E = kRegLanesElems;
  extern __shared__ float2 smem[];
  float2* ring = smem;
  float2* stw = smem + kRegSlots * E;
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  const int64_t step = gridDim.x;
  reg_load_table<N>(stw, tw_g);
  int64_t tile = blockIdx.x;
  if (MODE == 0) {
#pragma unroll
    for (int s = 0; s < kRegSlots - 1; ++s)
      reg_lanes_fetch<N, INV>(ring + s * E, xr, xc, B, tile + s * step, tiles);
  }
  float acc = 0.f;
  for (int it = 0; tile < tiles; ++it, tile += step) {
    float2* slot = ring + it % kRegSlots * E;
    float2 v[8];
    if (MODE == 0) {
      cp_async_wait<kRegSlots - 2>();
      __syncthreads();
      reg_lanes_fetch<N, INV>(ring + (it + kRegSlots - 1) % kRegSlots * E, xr,
                              xc, B, tile + (kRegSlots - 1) * step, tiles);
      reg_lanes_read<N, INV>(v, slot, xr != nullptr, g, t, Identity());
      const int64_t r = tile * G + g;
      if (r < B) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = reg_out<N, INV>(t, i);
          epi(r * N + k, k, r, 0, v[i]);
        }
      }
    } else {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = make_float2((float)(t + q * T), (float)g);
      reg_fft<N, true, 1, INV>(v, slot + g * N, stw, t, 0);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += v[i].x + v[i].y;
    }
  }
  if (MODE == 1 && never(acc)) epi(0, 0, 0, 0, make_float2(acc, 0.f));
}

// reg_sublanes_kernel (on the clusters its epilogue takes) without its
// stages (MODE 0) or without its global traffic (MODE 1).
template <int N, int MODE, class Epi>
__global__ void __launch_bounds__(reg_sublanes_threads(N),
                                  1024 / reg_sublanes_threads(N))
reg_sublanes_probe(const float* __restrict__ xr, const float2* __restrict__ xc,
                   const float2* __restrict__ tw_g, int64_t L, int64_t ncols,
                   int64_t tiles, Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
  constexpr int T = N / 8, C = reg_cols(N), E = N * C, CL = reg_cluster<Epi>;
  extern __shared__ float2 smem[];
  float2* ring = smem;
  float2* stw = smem + kRegSlots * E;
  const int c = threadIdx.x % C, t = threadIdx.x / C;
  const int64_t step = gridDim.x, lead = blockIdx.x - blockIdx.x % CL;
  reg_load_table<N>(stw, tw_g);
  int64_t tile = blockIdx.x;
  if (MODE == 0) {
#pragma unroll
    for (int s = 0; s < kRegSlots - 1; ++s)
      reg_sublanes_fetch<N>(ring + s * E, xr, xc, L, ncols, tile + s * step, tiles);
  }
  float acc = 0.f;
  int it = 0;
  for (; lead + it * step < tiles; ++it, tile += step) {
    float2* slot = ring + it % kRegSlots * E;
    float2 v[8];
    if (MODE == 0) cp_async_wait<kRegSlots - 2>();
    __syncthreads();
    if (it > 0) cluster_wait();
    if (MODE == 0)
      reg_sublanes_fetch<N>(ring + (it + kRegSlots - 1) % kRegSlots * E, xr,
                            xc, L, ncols, tile + (kRegSlots - 1) * step, tiles);
    cluster_arrive();
    if (MODE == 0) {
      reg_sublanes_read<N, INV>(v, slot, xr != nullptr, t, c);
      const int64_t prefix = tile / ncols;
      const int64_t col = (tile - prefix * ncols) * C + c;
      if (tile < tiles && col < L) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = reg_out<N, INV>(t, i);
          epi((prefix * N + k) * L + col, k, col, (int)prefix, v[i]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = make_float2((float)(t + q * T), (float)c);
      reg_fft<N, false, C, INV>(v, slot, stw, t, c);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += v[i].x + v[i].y;
    }
  }
  if (it > 0) cluster_wait();
  if (MODE == 1 && never(acc)) epi(0, 0, 0, 0, make_float2(acc, 0.f));
}

// small_lanes_kernel without its stages: each row handed on as it was read.
template <class Epi>
__global__ void __launch_bounds__(kSmallMaxWarps * 32)
small_lanes_copy(const float* __restrict__ xr, const float2* __restrict__ xc,
                 const void* __restrict__ plan_g, int plan_bytes, int n, int64_t B,
                 Epi epi) {
  extern __shared__ __align__(16) char small_smem[];
  const int G = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)blockIdx.x * G;
  const int rows = (int)(B - row0 < G ? B - row0 : G);
  char* staged = small_smem + plan_bytes;
  double2* a = reinterpret_cast<double2*>(staged + round16(G * n * 8)) + w * (2 * n + 1);
  small_lanes_fetch(small_smem, staged, plan_g, plan_bytes, xr, xc, row0, rows, n);
  if (w >= rows) return;
  small_lanes_widen(a, staged, xr != nullptr, w, n, lane, Identity());
  const int64_t r = row0 + w;
  for (int k = lane; k < n; k += 32) small_emit(epi, r * n + k, k, r, 0, a[k]);
}

// small_sublanes_kernel without its stages.
template <class Epi>
__global__ void __launch_bounds__(kSmallMaxWarps * 32)
small_sublanes_copy(const float* __restrict__ xr, const float2* __restrict__ xc,
                    const void* __restrict__ plan_g, int plan_bytes, int n, int64_t L,
                    Epi epi) {
  extern __shared__ __align__(16) char small_smem[];
  const int C = blockDim.x >> 5, logC = __ffs(C) - 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 = (int64_t)blockIdx.x * C, base = (int64_t)blockIdx.y * n * L;
  const int cols = (int)(L - col0 < C ? L - col0 : C);
  char* staged = small_smem + plan_bytes;
  double2* bufs = reinterpret_cast<double2*>(staged + round16(n * (C + 1) * 8));
  small_sublanes_fetch(small_smem, staged, plan_g, plan_bytes, xr, xc, base, col0,
                       cols, n, L, C, logC);
  if (w < cols) small_sublanes_widen(bufs + w * (2 * n + 1), staged, xr != nullptr, w, n, C, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
    const int k = i >> logC, c = i & (C - 1);
    if (c >= cols) continue;
    const int64_t col = col0 + c;
    small_emit(epi, base + (int64_t)k * L + col, k, col, (int)blockIdx.y,
               bufs[c * (2 * n + 1) + k]);
  }
}

// InvStore on the other cluster size (mode 3).
struct InvStoreOther : InvStore {};
template <>
constexpr bool is_inverse<InvStoreOther> = true;
template <>
constexpr int reg_cluster<InvStoreOther> =
    reg_cluster<InvStore> == 1 ? kRegCluster : 1;

template <class K>
cudaError_t launch(K kernel, dim3 grid, unsigned threads, size_t smem,
                   cudaStream_t stream, void** args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel((const void*)kernel, grid, dim3(threads), args, smem,
                       stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The probes' output: the forward's complex values, or the inverse's
// (the real part on lanes, as the solver's last inverse writes it).
InvStore inv_store(void* out, int64_t n, bool lanes) {
  return InvStore{lanes ? (float*)out : nullptr, lanes ? nullptr : (float2*)out,
                  (float)n};
}

}  // namespace

extern "C" {

// mode 0, 1 or 2 of the tile lanes kernel over (B, n); the inverse has
// mode 2 only.
cudaError_t probe_tile_lanes(int mode, int inverse, const void* xr,
                             const void* xc, void* out, const void* tw,
                             int64_t B, int64_t n, int64_t b, int sink,
                             cudaStream_t stream) {
  Plan p;
  if (B < 1 || !make_plan(&p, n, b) || mode < 0 || mode > 2 ||
      (inverse && mode != 2))
    return cudaErrorInvalidValue;
  const float* r = (const float*)xr;
  const float2* c = (const float2*)xc;
  float2* o = (float2*)out;
  const float2* t = (const float2*)tw;
  const dim3 grid((unsigned)((B + p.T - 1) / p.T));
  const size_t smem = smem_bytes(p);
  if (mode == 2) {
    Identity pre;
    Store st{o};
    InvStore inv = inv_store(out, n, true);
    void* fwd[] = {&r, &c, &t, &p, &B, &pre, &st};
    void* back[] = {&r, &c, &t, &p, &B, &pre, &inv};
    return inverse ? launch(tile_lanes_kernel<Identity, InvStore>, grid, kThreads,
                            smem, stream, back)
                   : launch(tile_lanes_kernel<Identity, Store>, grid, kThreads,
                            smem, stream, fwd);
  }
  void* args[] = {&r, &c, &o, &t, &p, &B, &sink};
  return mode == 0 ? launch(tile_lanes_probe<0>, grid, kThreads, smem, stream, args)
                   : launch(tile_lanes_probe<1>, grid, kThreads, smem, stream, args);
}

// mode 0, 1 or 2 of the tile sublanes kernel over (P, n, L); the inverse
// has mode 2 only.
cudaError_t probe_tile_sublanes(int mode, int inverse, const void* xr,
                                const void* xc, void* out, const void* tw,
                                int64_t P, int64_t n, int64_t L, int64_t b,
                                int sink, cudaStream_t stream) {
  Plan p;
  if (P < 1 || P > 65535 || L < 1 || !make_plan(&p, n, b) || mode < 0 ||
      mode > 2 || (inverse && mode != 2))
    return cudaErrorInvalidValue;
  const float* r = (const float*)xr;
  const float2* c = (const float2*)xc;
  float2* o = (float2*)out;
  const float2* t = (const float2*)tw;
  const dim3 grid((unsigned)((L + p.T - 1) / p.T), (unsigned)P);
  const size_t smem = smem_bytes(p);
  if (mode == 2) {
    Store st{o};
    InvStore inv = inv_store(out, n, false);
    void* fwd[] = {&r, &c, &t, &p, &L, &st};
    void* back[] = {&r, &c, &t, &p, &L, &inv};
    return inverse ? launch(tile_sublanes_kernel<InvStore>, grid, kThreads, smem,
                            stream, back)
                   : launch(tile_sublanes_kernel<Store>, grid, kThreads, smem,
                            stream, fwd);
  }
  void* args[] = {&r, &c, &o, &t, &p, &L, &sink};
  return mode == 0 ? launch(tile_sublanes_probe<0>, grid, kThreads, smem, stream, args)
                   : launch(tile_sublanes_probe<1>, grid, kThreads, smem, stream, args);
}

// mode 0 or 1 of the register lanes kernel over (B, 512), on its grid.
cudaError_t probe_reg_lanes(int mode, int inverse, const void* xr,
                            const void* xc, void* out, const void* tw,
                            int64_t B, int64_t n, int64_t b, int,
                            cudaStream_t stream) {
  constexpr int N = 512, G = kRegLanesThreads / (N / 8);
  constexpr size_t smem = reg_smem<N>(kRegLanesElems);
  static int resident[4][kRegDevices];
  if (B < 1 || n != N || !reg_path(n, b) || mode < 0 || mode > 1)
    return cudaErrorInvalidValue;
  const float* r = (const float*)xr;
  const float2* c = (const float2*)xc;
  const float2* t = (const float2*)tw;
  const int64_t tiles = (B + G - 1) / G;
  const Store st{(float2*)out};
  const InvStore inv = inv_store(out, n, true);
#define MTT_PROBE(MODE, EPI, E)                                              \
  reg_launch(reg_lanes_probe<N, MODE, EPI>, kRegLanesThreads, smem, 1, tiles, \
             resident[2 * inverse + MODE], stream, r, c, t, B, tiles, E)
  if (inverse)
    return mode == 0 ? MTT_PROBE(0, InvStore, inv) : MTT_PROBE(1, InvStore, inv);
  return mode == 0 ? MTT_PROBE(0, Store, st) : MTT_PROBE(1, Store, st);
#undef MTT_PROBE
}

// mode 0 or 1 of the register sublanes kernel over (P, 512, L), on its
// grid and clusters; mode 3 (inverse) the shipped kernel on the other
// cluster size.
cudaError_t probe_reg_sublanes(int mode, int inverse, const void* xr,
                               const void* xc, void* out, const void* tw,
                               int64_t P, int64_t n, int64_t L, int64_t b,
                               int, cudaStream_t stream) {
  constexpr int N = 512, C = reg_cols(N), THREADS = reg_sublanes_threads(N);
  constexpr size_t smem = reg_smem<N>(N * C);
  static int resident[5][kRegDevices];
  if (P < 1 || L < 1 || n != N || !reg_path(n, b) || mode < 0 || mode > 3 ||
      mode == 2 || (mode == 3 && !inverse))
    return cudaErrorInvalidValue;
  const float* r = (const float*)xr;
  const float2* c = (const float2*)xc;
  const float2* t = (const float2*)tw;
  const int64_t ncols = (L + C - 1) / C, tiles = P * ncols;
  const Store st{(float2*)out};
  const InvStore inv = inv_store(out, n, false);
  if (mode == 3)
    return reg_launch(reg_sublanes_kernel<N, InvStoreOther>, THREADS, smem,
                      reg_cluster<InvStoreOther>, tiles, resident[4], stream, r,
                      c, t, L, ncols, tiles, InvStoreOther{inv});
#define MTT_PROBE(MODE, EPI, E)                                                 \
  reg_launch(reg_sublanes_probe<N, MODE, EPI>, THREADS, smem, reg_cluster<EPI>, \
             tiles, resident[2 * inverse + MODE], stream, r, c, t, L, ncols,    \
             tiles, E)
  if (inverse)
    return mode == 0 ? MTT_PROBE(0, InvStore, inv) : MTT_PROBE(1, InvStore, inv);
  return mode == 0 ? MTT_PROBE(0, Store, st) : MTT_PROBE(1, Store, st);
#undef MTT_PROBE
}

// mode 0 (copy only) or 1 (whole) of the small-extent lanes kernel over (B,
// n), `width` rows a block (0: the launcher's).
cudaError_t probe_small_lanes(int mode, int inverse, const void* xr,
                              const void* xc, void* out, const void* plan,
                              int64_t B, int64_t n, int64_t b, int width,
                              cudaStream_t stream) {
  const int warps = width ? width : kSmallRows;
  if (B < 1 || !small_path(n, b) || mode < 0 || mode > 1 || warps < 1 ||
      warps > kSmallMaxWarps)
    return cudaErrorInvalidValue;
  const float* r = (const float*)xr;
  const float2* c = (const float2*)xc;
  const Store st{(float2*)out};
  const InvStore inv = inv_store(out, n, true);
  if (mode == 1)
    return inverse ? launch_small_lanes(r, c, plan, B, n, warps, stream, Identity(), inv)
                   : launch_small_lanes(r, c, plan, B, n, warps, stream, Identity(), st);
  int bytes = small_plan_bytes(n), ni = (int)n;
  const dim3 grid((unsigned)((B + warps - 1) / warps));
  const size_t smem = small_smem_bytes(n, warps, false);
  void* fwd[] = {&r, &c, &plan, &bytes, &ni, &B, (void*)&st};
  void* back[] = {&r, &c, &plan, &bytes, &ni, &B, (void*)&inv};
  return inverse ? launch(small_lanes_copy<InvStore>, grid, warps * 32, smem, stream, back)
                 : launch(small_lanes_copy<Store>, grid, warps * 32, smem, stream, fwd);
}

// mode 0 (copy only) or 1 (whole) of the small-extent sublanes kernel over
// (P, n, L), `width` columns a block (a power of two; 0: the launcher's).
cudaError_t probe_small_sublanes(int mode, int inverse, const void* xr,
                                 const void* xc, void* out, const void* plan,
                                 int64_t P, int64_t n, int64_t L, int64_t b,
                                 int width, cudaStream_t stream) {
  const int warps = width ? width : kSmallCols;
  if (P < 1 || P > 65535 || L < 1 || !small_path(n, b) || mode < 0 || mode > 1 ||
      warps < 1 || warps > kSmallMaxWarps || (warps & (warps - 1)))
    return cudaErrorInvalidValue;
  const float* r = (const float*)xr;
  const float2* c = (const float2*)xc;
  const Store st{(float2*)out};
  const InvStore inv = inv_store(out, n, false);
  if (mode == 1)
    return inverse ? launch_small_sublanes(r, c, plan, P, n, L, warps, stream, inv)
                   : launch_small_sublanes(r, c, plan, P, n, L, warps, stream, st);
  int bytes = small_plan_bytes(n), ni = (int)n;
  const dim3 grid((unsigned)((L + warps - 1) / warps), (unsigned)P);
  const size_t smem = small_smem_bytes(n, warps, true);
  void* fwd[] = {&r, &c, &plan, &bytes, &ni, &L, (void*)&st};
  void* back[] = {&r, &c, &plan, &bytes, &ni, &L, (void*)&inv};
  return inverse ? launch(small_sublanes_copy<InvStore>, grid, warps * 32, smem, stream, back)
                 : launch(small_sublanes_copy<Store>, grid, warps * 32, smem, stream, fwd);
}

}  // extern "C"
