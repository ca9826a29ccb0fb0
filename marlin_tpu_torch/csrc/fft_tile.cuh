// Shared device code of the unordered-FFT kernels (sm_90a): the tile FFT,
// the plan, and the two forward kernels that other sources instantiate with
// their own functors.
//
// Included by unordered_fft.cu (kernels 1-4), spectral_update.cu (the fused
// k-space update, kernels 5-6) and the sources that unordered_fft.py
// generates for a fused pointwise read (kernel 1's `pre`).  Everything is in
// an anonymous namespace: each library gets its own copy.
//
// Algorithm: one block holds a tile of T transforms of length n in shared
// memory and runs a mixed-radix Stockham FFT over it, one stage per radix.
// The plan takes radix 8, then 4, then 2, then odd primes.  A power-of-two
// stage gives each thread whole butterflies: R loads, R-1 twiddles from
// the table, DFT_R in registers, R stores.  An odd-radix stage (a prime
// extent is one such stage) sums each output directly over its R inputs,
//
//   out[o] = sum_{q<R} in[j + q*n/R] * W_n^{q*m*n/(Ns*R)},
//
// with Ns the product of the radices already done, jlow = o mod Ns,
// t = (o/Ns) mod R, j = (o/(Ns*R))*Ns + jlow and m = jlow + t*Ns.  All
// stage twiddles come from one table W_n^j, j < n, computed in float64 on
// the host and rounded to float32 (as marlin_tpu/pallas_fft.py:_tables
// does); sums accumulate in float32.  The permutation to (or from) the
// unordered order happens on the way out of (or into) shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 24;
constexpr int kThreads = 256;
constexpr int kTileElems = 4096;  // complex values per tile (64 KB ping-pong)
constexpr int kMaxN = 1024;

struct Plan {
  int n;      // transform length
  int b;      // n = b * r; forward output slot k' = t*b + s holds k = t + r*s
  int r;
  int T;      // transforms per tile
  int nstages;
  int rad[kMaxStages];
};

// Permuted slot k' -> natural frequency index (true_k_order in Python).
__device__ __forceinline__ int true_k(int kp, const Plan& p) {
  return kp / p.b + p.r * (kp % p.b);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// s*i*a for s = -1 (forward) or +1 (inverse)
template <bool INV>
__device__ __forceinline__ float2 mul_si(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// In-register DFT_R, R in {2, 4, 8}: V[t] = sum_q v[q] W_R^{-+qt}.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2, false>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}
template <>
__device__ __forceinline__ void dft<2, true>(float2 (&v)[2]) {
  dft<2, false>(v);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 apc = cadd(a, c), amc = csub(a, c);
  const float2 bpd = cadd(b, d), bmd = mul_si<INV>(csub(b, d));
  a = cadd(apc, bpd);
  b = cadd(amc, bmd);
  c = csub(apc, bpd);
  d = csub(amc, bmd);
}

template <>
__device__ __forceinline__ void dft<4, false>(float2 (&v)[4]) {
  dft4<false>(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void dft<4, true>(float2 (&v)[4]) {
  dft4<true>(v[0], v[1], v[2], v[3]);
}

template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  // even and odd halves, then W_8^k (k = 0..3) on the odd half
  dft4<INV>(v[0], v[2], v[4], v[6]);
  dft4<INV>(v[1], v[3], v[5], v[7]);
  const float h = 0.70710678118654752f;
  const float s = INV ? 1.f : -1.f;
  const float2 o1 = cmul(v[3], make_float2(h, s * h));
  const float2 o2 = mul_si<INV>(v[5]);
  const float2 o3 = cmul(v[7], make_float2(-h, s * h));
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  v[0] = cadd(e0, v[1]);
  v[4] = csub(e0, v[1]);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

template <>
__device__ __forceinline__ void dft<8, false>(float2 (&v)[8]) {
  dft8<false>(v);
}
template <>
__device__ __forceinline__ void dft<8, true>(float2 (&v)[8]) {
  dft8<true>(v);
}

// Element (k, l) of a tile (k along the transform, l the transform's index
// in the tile) lives at l*n + k when LANES, else at k*T + l.
template <bool LANES>
__device__ __forceinline__ int at(int k, int l, int n, int T) {
  return LANES ? l * n + k : k * T + l;
}

// One radix-R Stockham stage (R in {2, 4, 8}, Ns a power of two, 2^logNs):
// butterfly j reads x[j + q*n/R], twiddles by W_n^{q*(j mod Ns)*n/(Ns*R)},
// runs DFT_R in registers and writes (j/Ns)*Ns*R + (j mod Ns) + t*Ns.
template <int R, bool INV, bool LANES>
__device__ __forceinline__ void stage_pow2(const float2* a, float2* c,
                                           const float2* tw, int n, int T,
                                           int Ns, int logNs) {
  const int nR = n / R;
  const int stride = n / (Ns * R);
  const int nb = nR * T;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    int j, l;
    if (LANES) {
      j = i % nR;
      l = i / nR;
    } else {
      l = i % T;
      j = i / T;
    }
    const int jlow = j & (Ns - 1);
    const int out0 = ((j >> logNs) << logNs) * R + jlow;
    const int step = jlow * stride;  // q*step < n
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = a[at<LANES>(j + q * nR, l, n, T)];
#pragma unroll
    for (int q = 1; q < R; ++q) v[q] = cmul(v[q], tw[q * step]);
    dft<R, INV>(v);
#pragma unroll
    for (int t = 0; t < R; ++t) c[at<LANES>(out0 + t * Ns, l, n, T)] = v[t];
  }
}

// Any other radix (odd primes, up to a whole prime extent): every output
// is summed directly over its R inputs,
//   out[o] = sum_{q<R} x[j + q*n/R] * W_n^{q*(jlow + t*Ns)*n/(Ns*R)},
// with jlow = o mod Ns, t = (o/Ns) mod R, j = (o/(Ns*R))*Ns + jlow.
template <bool LANES>
__device__ __forceinline__ void stage_direct(const float2* a, float2* c,
                                             const float2* tw, int n, int T,
                                             int Ns, int R) {
  const int nR = n / R;
  const int stride = n / (Ns * R);
  const int E = n * T;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    int o, l;
    if (LANES) {
      o = i % n;
      l = i / n;
    } else {
      l = i % T;
      o = i / T;
    }
    const int jlow = o % Ns;
    const int t = (o / Ns) % R;
    const int j = (o / (Ns * R)) * Ns + jlow;
    const int step = (jlow + t * Ns) * stride;  // < n
    float ax = 0.f, ay = 0.f;
    int idx = 0;
    for (int q = 0; q < R; ++q) {
      const float2 v = a[at<LANES>(j + q * nR, l, n, T)];
      const float2 w = tw[idx];
      ax = fmaf(v.x, w.x, fmaf(-v.y, w.y, ax));
      ay = fmaf(v.x, w.y, fmaf(v.y, w.x, ay));
      idx += step;
      if (idx >= n) idx -= n;
    }
    c[i] = make_float2(ax, ay);  // i is element (o, l)
  }
}

// Runs every Stockham stage over the tile in `a` (scratch `c`) and returns
// the buffer that holds the natural-order result.  The plan puts the
// radices 8, 4, 2 first, so Ns is a power of two in every stage_pow2.
template <bool LANES, bool INV>
__device__ float2* tile_fft(float2* a, float2* c, const float2* tw,
                            const Plan& p) {
  const int n = p.n;
  const int T = p.T;
  int Ns = 1, logNs = 0;
  for (int s = 0; s < p.nstages; ++s) {
    const int R = p.rad[s];
    if (R == 8) {
      stage_pow2<8, INV, LANES>(a, c, tw, n, T, Ns, logNs);
      logNs += 3;
    } else if (R == 4) {
      stage_pow2<4, INV, LANES>(a, c, tw, n, T, Ns, logNs);
      logNs += 2;
    } else if (R == 2) {
      stage_pow2<2, INV, LANES>(a, c, tw, n, T, Ns, logNs);
      logNs += 1;
    } else {
      stage_direct<LANES>(a, c, tw, n, T, Ns, R);
    }
    __syncthreads();
    float2* tmp = a;
    a = c;
    c = tmp;
    Ns *= R;
  }
  return a;
}

__device__ __forceinline__ void load_table(float2* tw, const float2* tw_g,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tw[i] = tw_g[i];
}

// Factor n into Stockham radices; false when the extents are not a valid
// unordered-FFT plan.
bool make_plan(Plan* p, int64_t n, int64_t b) {
  if (n < 2 || n > kMaxN || b < 1 || n % b != 0) return false;
  p->n = (int)n;
  p->b = (int)b;
  p->r = (int)(n / b);
  p->T = kTileElems / (int)n;
  if (p->T < 1) p->T = 1;
  const int pow2_radices[3] = {8, 4, 2};
  int m = (int)n, k = 0;
  for (int r : pow2_radices) {
    while (m % r == 0) {
      if (k == kMaxStages) return false;
      p->rad[k++] = r;
      m /= r;
    }
  }
  for (int f = 3; m > 1; f += 2) {
    while (m % f == 0) {
      if (k == kMaxStages) return false;
      p->rad[k++] = f;
      m /= f;
    }
  }
  p->nstages = k;
  return true;
}

size_t smem_bytes(const Plan& p) {
  return (2 * (size_t)p.n * p.T + p.n) * sizeof(float2);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Forward along the contiguous axis of (B, n): real (xr) or complex (xc)
// input, permuted complex output.  `pre` maps each real input value as it
// is read (Identity for a plain transform, a generated functor for the
// fused pointwise producer of pallas_fft.py:_fwd_lanes_kernel).
struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

template <class Pre>
__global__ void __launch_bounds__(kThreads)
fwd_lanes_kernel(const float* __restrict__ xr, const float2* __restrict__ xc,
                 float2* __restrict__ out, const float2* __restrict__ tw_g,
                 Plan p, int64_t B, Pre pre) {
  extern __shared__ float2 smem[];
  const int n = p.n, E = n * p.T;
  float2* a = smem;
  float2* c = smem + E;
  float2* tw = smem + 2 * E;
  const int64_t row0 = (int64_t)blockIdx.x * p.T;
  const int64_t base = row0 * n;
  load_table(tw, tw_g, n);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    if (row0 + i / n < B)
      v = xr ? make_float2(pre(xr[base + i]), 0.f) : xc[base + i];
    a[i] = v;
  }
  __syncthreads();
  const float2* res = tile_fft<true, false>(a, c, tw, p);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i / n, kp = i % n;
    if (row0 + l < B) out[base + i] = res[l * n + true_k(kp, p)];
  }
}

// Forward along axis 1 of (P, n, L): blockIdx.y picks the prefix batch,
// blockIdx.x a run of T columns.  Real (xr) or complex (xc) input.  Each
// output element goes to `epi(g, kp, col, prefix, value)`, with g its flat
// index and kp its permuted slot: Store writes it out, the fused k-space
// update of spectral_update.cu applies the ABM update to it.
struct Store {
  float2* out;
  __device__ __forceinline__ void operator()(int64_t g, int, int64_t, int,
                                             float2 v) const {
    out[g] = v;
  }
};

template <class Epi>
__global__ void __launch_bounds__(kThreads)
fwd_sublanes_kernel(const float* __restrict__ xr,
                    const float2* __restrict__ xc,
                    const float2* __restrict__ tw_g, Plan p, int64_t L,
                    Epi epi) {
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
    float2 v = make_float2(0.f, 0.f);
    if (col < L) {
      const int64_t g = base + (int64_t)k * L + col;
      v = xr ? make_float2(xr[g], 0.f) : xc[g];
    }
    a[i] = v;
  }
  __syncthreads();
  const float2* res = tile_fft<false, false>(a, c, tw, p);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i % T, kp = i / T;
    const int64_t col = col0 + l;
    if (col < L)
      epi(base + (int64_t)kp * L + col, kp, col, (int)blockIdx.y,
          res[true_k(kp, p) * T + l]);
  }
}

// Host launchers of the two forward kernels; each returns the launch's
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernels do
// not take).
template <class Pre>
cudaError_t launch_fwd_lanes(const float* xr, const float2* xc, float2* out,
                             const float2* tw, int64_t B, int64_t n, int64_t b,
                             cudaStream_t stream, Pre pre) {
  Plan p;
  if (B < 1 || !make_plan(&p, n, b)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p);
  cudaError_t e = allow_smem(fwd_lanes_kernel<Pre>, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (B + p.T - 1) / p.T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwd_lanes_kernel<Pre><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xc, out, tw, p, B, pre);
  return cudaGetLastError();
}

template <class Epi>
cudaError_t launch_fwd_sublanes(const float* xr, const float2* xc,
                                const float2* tw, int64_t P, int64_t n,
                                int64_t L, int64_t b, cudaStream_t stream,
                                Epi epi) {
  Plan p;
  if (P < 1 || P > 65535 || L < 1 || !make_plan(&p, n, b))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p);
  cudaError_t e = allow_smem(fwd_sublanes_kernel<Epi>, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (L + p.T - 1) / p.T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)P);
  fwd_sublanes_kernel<Epi><<<grid, kThreads, smem, stream>>>(xr, xc, tw, p, L,
                                                             epi);
  return cudaGetLastError();
}

}  // namespace
