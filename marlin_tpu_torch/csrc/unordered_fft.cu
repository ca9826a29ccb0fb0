// Unordered (permuted-spectrum) FFT kernels for Hopper (sm_90a).
//
// Four kernels replace the four Pallas kernels of marlin_tpu/pallas_fft.py:
//
//   mtt_fwd_lanes     <- _fwd_lanes_kernel     (forward, contiguous axis)
//   mtt_inv_lanes     <- _inv_lanes_kernel     (inverse, contiguous axis)
//   mtt_fwd_sublanes  <- _fwd_sublanes_kernel  (forward, strided axis)
//   mtt_inv_sublanes  <- _inv_sublanes_kernel  (inverse, strided axis)
//
// The contract they keep is the storage order of the spectrum, not the TPU
// kernels' blocking: with n = b*r (b = base(n) in unordered_fft.py), a
// forward transform stores the natural frequency k = t + r*s at slot
// k' = t*b + s, and an inverse transform reads that order and writes
// natural-order real space scaled by 1/n.  The tile FFT and the two forward
// kernels live in fft_tile.cuh, shared with the fused kernels; the fused
// pointwise read of _fwd_lanes_kernel (`pre`) is the same forward lanes
// kernel instantiated with a generated functor (unordered_fft.py).
//
// Bound: at 512^3 a pass moves 1.6-2.1 GB, 0.48-0.64 ms at 3.35 TB/s; the
// FFT's 5*n*log2(n) flop a transform come to 6.0e9 a pass, 0.09 ms at
// 67 TFLOP/s, so it is bound by bytes.
// The forward kernels take the register-resident path of fft_tile.cuh for
// n = 128, 256, 512 and 1024 (a persistent block, a cp.async ring of
// tiles, 8 values a thread, the exchanges in the tile's own ring slot,
// stores straight to the permuted slot) and the generic shared-memory tile
// otherwise; the launchers choose by n (mtt_fwd_path says which).  The two
// inverse kernels here keep the generic tile at every extent: one 64 KB
// ping-pong tile per block (three blocks an SM), one trip through shared
// memory a stage.

#include "fft_tile.cuh"

namespace {

// Inverse along the contiguous axis of (B, n): permuted complex input,
// natural-order output times 1/n, real part only (out_r) or complex (out_c).
__global__ void __launch_bounds__(kThreads)
inv_lanes_kernel(const float2* __restrict__ x, float* __restrict__ out_r,
                 float2* __restrict__ out_c, const float2* __restrict__ tw_g,
                 Plan p, int64_t B) {
  extern __shared__ float2 smem[];
  const int n = p.n, E = n * p.T;
  float2* a = smem;
  float2* c = smem + E;
  float2* tw = smem + 2 * E;
  const int64_t row0 = (int64_t)blockIdx.x * p.T;
  const int64_t base = row0 * n;
  load_table(tw, tw_g, n);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i / n, kp = i % n;
    float2 v = make_float2(0.f, 0.f);
    if (row0 + l < B) v = x[base + i];
    a[l * n + true_k(kp, p)] = v;
  }
  __syncthreads();
  const float2* res = tile_fft<true, true>(a, c, tw, p);
  const float scale = 1.0f / (float)n;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    if (row0 + i / n >= B) continue;
    const float2 v = res[i];
    if (out_r)
      out_r[base + i] = v.x * scale;
    else
      out_c[base + i] = make_float2(v.x * scale, v.y * scale);
  }
}

// Inverse along axis 1 of (P, n, L): permuted complex input, natural-order
// complex output times 1/n.
__global__ void __launch_bounds__(kThreads)
inv_sublanes_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                    const float2* __restrict__ tw_g, Plan p, int64_t L) {
  extern __shared__ float2 smem[];
  const int n = p.n, T = p.T, E = n * T;
  float2* a = smem;
  float2* c = smem + E;
  float2* tw = smem + 2 * E;
  const int64_t base = (int64_t)blockIdx.y * n * L;
  const int64_t col0 = (int64_t)blockIdx.x * T;
  load_table(tw, tw_g, n);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i % T, kp = i / T;
    const int64_t col = col0 + l;
    float2 v = make_float2(0.f, 0.f);
    if (col < L) v = x[base + (int64_t)kp * L + col];
    a[true_k(kp, p) * T + l] = v;
  }
  __syncthreads();
  const float2* res = tile_fft<false, true>(a, c, tw, p);
  const float scale = 1.0f / (float)n;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i % T, k = i / T;
    const int64_t col = col0 + l;
    if (col < L) {
      const float2 v = res[i];
      out[base + (int64_t)k * L + col] = make_float2(v.x * scale, v.y * scale);
    }
  }
}

}  // namespace

extern "C" {

// 1 when the forward kernels of extent n (DFT size b) take the register
// path of fft_tile.cuh, 0 for the generic tile.
int mtt_fwd_path(int64_t n, int64_t b) { return reg_path(n, b) ? 1 : 0; }

// Bytes of dynamic shared memory a block of the forward lanes (sublanes = 0)
// or sublanes kernel of extent n takes; 0 for an extent they do not take.
int mtt_fwd_smem(int64_t n, int64_t b, int sublanes) {
  return (int)fwd_smem_bytes(n, b, sublanes != 0);
}

// x_real or x_cplx (the other null): (B, n); out: (B, n) complex.
cudaError_t mtt_fwd_lanes(const void* x_real, const void* x_cplx, void* out,
                          const void* tw, int64_t B, int64_t n, int64_t b,
                          cudaStream_t stream) {
  return launch_fwd_lanes((const float*)x_real, (const float2*)x_cplx,
                          (float2*)out, (const float2*)tw, B, n, b, stream,
                          Identity());
}

// x: (B, n) complex, permuted; out_real or out_cplx (the other null).
cudaError_t mtt_inv_lanes(const void* x, void* out_real, void* out_cplx,
                          const void* tw, int64_t B, int64_t n, int64_t b,
                          cudaStream_t stream) {
  Plan p;
  if (B < 1 || !make_plan(&p, n, b)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p);
  cudaError_t e = allow_smem(inv_lanes_kernel, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (B + p.T - 1) / p.T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  inv_lanes_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float2*)x, (float*)out_real, (float2*)out_cplx,
      (const float2*)tw, p, B);
  return cudaGetLastError();
}

// x_real or x_cplx (the other null): (P, n, L); out: (P, n, L) complex.
cudaError_t mtt_fwd_sublanes(const void* x_real, const void* x_cplx,
                             void* out, const void* tw, int64_t P, int64_t n,
                             int64_t L, int64_t b, cudaStream_t stream) {
  return launch_fwd_sublanes((const float*)x_real, (const float2*)x_cplx,
                             (const float2*)tw, P, n, L, b, stream,
                             Store{(float2*)out});
}

// x: (P, n, L) complex, permuted along n; out: (P, n, L) complex.
cudaError_t mtt_inv_sublanes(const void* x, void* out, const void* tw,
                             int64_t P, int64_t n, int64_t L, int64_t b,
                             cudaStream_t stream) {
  Plan p;
  if (P < 1 || P > 65535 || L < 1 || !make_plan(&p, n, b))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p);
  cudaError_t e = allow_smem(inv_sublanes_kernel, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (L + p.T - 1) / p.T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)P);
  inv_sublanes_kernel<<<grid, kThreads, smem, stream>>>(
      (const float2*)x, (float2*)out, (const float2*)tw, p, L);
  return cudaGetLastError();
}

}  // extern "C"
