// Shared device code of the unordered-FFT kernels (sm_90a): the generic
// tile FFT, the register-resident kernels of power-of-two extents, the
// plan, and the two launchers (lanes, sublanes) that other sources
// instantiate with their own functors.
//
// Included by unordered_fft.cu (kernels 1-4), spectral_update.cu (the fused
// k-space update, kernels 5-6) and the sources that unordered_fft.py
// generates for a fused pointwise read (kernel 1's `pre`).  Everything is in
// an anonymous namespace: each library gets its own copy.
//
// A kernel's direction follows its epilogue (is_inverse<Epi>): InvStore's
// kernels are the inverse (permuted input, the conjugate table, natural
// output divided by n), every other epilogue's the forward (natural input,
// permuted output).  Three paths, chosen on the host by the extent
// (fft_path):
//
// * n = 128, 256, 512, 1024 (b = 128): the register-resident kernels
//   reg_lanes_kernel<N> and reg_sublanes_kernel<N>, which replace
//   marlin_tpu/pallas_fft.py:237 _fwd_lanes_kernel (kernel 1, with `pre`
//   kernel 1'), :276 _inv_lanes_kernel (kernel 2), :340
//   _fwd_sublanes_kernel (kernel 3, with the k-space update kernels 5-6)
//   and :355 _inv_sublanes_kernel (kernel 4).  They are bound by bytes: at
//   512^3 a real-input or real-output lanes pass moves 1.61 GB (0.48 ms at
//   3.35 TB/s), a complex sublanes pass 2.15 GB (0.64 ms); the FFT's
//   5 n log2 n flop a transform come to 0.09 ms at 67 TFLOP/s.  What held
//   the shared-memory tile back was its global traffic (one load in flight
//   a thread, three blocks an SM): its loads and stores alone took 1.42 ms
//   of its 1.81 (fft_probe.py on an NVIDIA H100 80GB HBM3, 700.00 W).  So a
//   persistent block walks the tiles with a three-slot cp.async ring of
//   16-byte copies: the next two tiles' copies are in flight while this
//   one's butterflies run.  T = N/8 threads share a transform and each
//   holds 8 values in registers; with N = R_0 R_1 ... (8, 8, then 2, 4 or
//   8, then 2) thread t runs butterflies t + T m of every Stockham stage,
//   so there are only (stages - 1) exchanges, each through the tile's own
//   ring slot (swizzled on the contiguous axis); twiddles come from a
//   per-stage table laid out [q][j mod Ns] (no bank conflicts); after the
//   last stage thread t holds k = t + T m + (N/R) u.  The forward reads
//   x[t + T q] in place and stores k to its permuted slot k'; the inverse
//   reads x[t + T q] from its permuted slot (the lanes copies swizzled so
//   that these reads are free of bank conflicts) and stores k in natural
//   order, which neighbouring threads write to neighbouring addresses.
//   Neither has a read-out pass.  The strided axis takes C = 32, 32, 16, 8
//   columns a tile at n = 128, 256, 512, 1024 (C * N/8 = 512 or 1024
//   threads a block; 128 B of each row at n = 512); with the plain stores
//   (kernels 3 and 4) its blocks run in clusters of 8 that take adjacent
//   tiles in step, so that each row is read and written 8 tiles wide at a
//   time.  Every index is a shift or a mask: N is a template parameter.
// * every extent with b = n but 128 (8 .. 400): the small-extent kernels
//   small_lanes_kernel and small_sublanes_kernel, one warp a transform,
//   float64 stages (their section below);
// * n = 384, 640, 768, 896 (b = 128, r = 3, 5, 6, 7): the generic tile
//   (tile_fft) below.
//
// Generic tile algorithm: one block holds a tile of T transforms of length
// n in shared memory and runs a mixed-radix Stockham FFT over it, one stage
// per radix.  The plan takes radix 8, then 4, then 2, then odd primes.  A
// power-of-two stage gives each thread whole butterflies: R loads, R-1
// twiddles from the table, DFT_R in registers, R stores.  An odd-radix stage
// (a prime extent is one such stage) sums each output directly over its R
// inputs,
//
//   out[o] = sum_{q<R} in[j + q*n/R] * W_n^{q*m*n/(Ns*R)},
//
// with Ns the product of the radices already done, jlow = o mod Ns,
// t = (o/Ns) mod R, j = (o/(Ns*R))*Ns + jlow and m = jlow + t*Ns.  All
// stage twiddles come from one table W_n^j, j < n (W_n^-j for the inverse),
// computed in float64 on the host and rounded to float32 (as
// marlin_tpu/pallas_fft.py:_tables does); sums accumulate in float32.  The
// permutation to (or from) the unordered order happens on the way out of
// (or into) shared memory.  Both paths do the same operations in the same
// order (the register path reads the same table entries and skips only the
// first stage's multiplies by W^0 = 1), so they agree bit for bit.

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
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cplx(float re, float im) {
  return make_float2(re, im);
}
__device__ __forceinline__ double2 cplx(double re, double im) {
  return make_double2(re, im);
}

// s*i*a for s = -1 (forward) or +1 (inverse)
template <bool INV, class C>
__device__ __forceinline__ C mul_si(C a) {
  return INV ? cplx(-a.y, a.x) : cplx(a.y, -a.x);
}

// In-register DFT_R, V[t] = sum_q v[q] W_R^{-+qt}, on float2 (the register
// path and the tile) or double2 values (the small-extent path): R = 2, 4, 8
// as butterflies, R = 3, 5, 7 by their symmetric pairs (dft_odd).
template <bool INV, class C>
__device__ __forceinline__ void dft4(C& a, C& b, C& c, C& d) {
  const C apc = cadd(a, c), amc = csub(a, c);
  const C bpd = cadd(b, d), bmd = mul_si<INV>(csub(b, d));
  a = cadd(apc, bpd);
  b = cadd(amc, bmd);
  c = csub(apc, bpd);
  d = csub(amc, bmd);
}

template <bool INV, class C>
__device__ __forceinline__ void dft8(C (&v)[8]) {
  using S = decltype(v[0].x);
  // even and odd halves, then W_8^k (k = 0..3) on the odd half
  dft4<INV>(v[0], v[2], v[4], v[6]);
  dft4<INV>(v[1], v[3], v[5], v[7]);
  const S h = S(0.70710678118654752440);
  const S s = INV ? S(1) : S(-1);
  const C o1 = cmul(v[3], cplx(h, s * h));
  const C o2 = mul_si<INV>(v[5]);
  const C o3 = cmul(v[7], cplx(-h, s * h));
  const C e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  v[0] = cadd(e0, v[1]);
  v[4] = csub(e0, v[1]);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// cos and sin of 2 pi m / R for R = 3, 5, 7 and 0 <= m < R, correctly
// rounded to double (selects on m, which the unrolled loops fold away)
__host__ __device__ constexpr double root_cos(int R, int m) {
  const int k = m < R - m ? m : R - m;
  if (k == 0) return 1.0;
  if (R == 3) return -0.5;
  if (R == 5) return k == 1 ? 0.3090169943749474241 : -0.8090169943749474241;
  return k == 1 ? 0.62348980185873353053
       : k == 2 ? -0.22252093395631440429 : -0.90096886790241912624;
}
__host__ __device__ constexpr double root_sin(int R, int m) {
  const int k = m < R - m ? m : R - m;
  const double s = k == 0 ? 0.0
                 : R == 3 ? 0.86602540378443864676
                 : R == 5 ? (k == 1 ? 0.95105651629515357212 : 0.58778525229247312917)
                 : k == 1 ? 0.78183148246802980871
                 : k == 2 ? 0.97492791218182360702 : 0.43388373911755812048;
  return m < R - m ? s : -s;
}

// Odd R (3, 5, 7) in double2: with a_k = v_k + v_{R-k}, b_k = v_k - v_{R-k},
// V_t = v_0 + sum_k cos(2 pi kt/R) a_k -+ i sum_k sin(2 pi kt/R) b_k and
// V_{R-t} the same with the other sign, k, t = 1 .. (R-1)/2.
template <int R, bool INV>
__device__ __forceinline__ void dft_odd(double2 (&v)[R]) {
  constexpr int M = (R - 1) / 2;
  double2 a[M + 1], b[M + 1];
  const double2 x0 = v[0];
  double2 y0 = x0;
#pragma unroll
  for (int k = 1; k <= M; ++k) {
    a[k] = cadd(v[k], v[R - k]);
    b[k] = csub(v[k], v[R - k]);
    y0 = cadd(y0, a[k]);
  }
#pragma unroll
  for (int t = 1; t <= M; ++t) {
    double2 re = x0, im = make_double2(0.0, 0.0);
#pragma unroll
    for (int k = 1; k <= M; ++k) {
      const double c = root_cos(R, k * t % R), s = root_sin(R, k * t % R);
      re = make_double2(fma(c, a[k].x, re.x), fma(c, a[k].y, re.y));
      im = make_double2(fma(s, b[k].x, im.x), fma(s, b[k].y, im.y));
    }
    const double2 si = mul_si<INV>(im);
    v[t] = cadd(re, si);
    v[R - t] = csub(re, si);
  }
  v[0] = y0;
}

template <int R, bool INV, class C>
__device__ __forceinline__ void dft(C (&v)[R]) {
  if constexpr (R == 2) {
    const C a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    dft8<INV>(v);
  } else {
    dft_odd<R, INV>(v);
  }
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

// `pre` maps each real input value as it is read (Identity for a plain
// transform, a generated functor for the fused pointwise producer of
// pallas_fft.py:_fwd_lanes_kernel).
struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

// Each output element of a kernel goes to `epi(g, k, col, prefix, value)`,
// with g its flat index, k its stored index along the transform (the
// permuted slot k' of the forward, the natural index of the inverse), col
// its row (lanes) or column (sublanes) and prefix its prefix batch
// (sublanes; 0 on lanes).  Store writes the forward's value out, the fused
// k-space update of spectral_update.cu applies the ABM update to it.
struct Store {
  float2* out;
  __device__ __forceinline__ void operator()(int64_t g, int, int64_t, int,
                                             float2 v) const {
    out[g] = v;
  }
};

// The inverse's store: the natural-order value divided by n, its real
// part only (out_r) or whole (out_c; out_r null).  A correctly rounded
// division, not a product with the rounded 1/n: float(1/n) is off by a
// fixed relative amount for n not a power of two (-2.2e-8 at n = 200), so
// every inverse would scale the field's mean by it, and a solver that
// transforms back and forth each substep would drift its mass.
struct InvStore {
  float* out_r;
  float2* out_c;
  float n;
  __device__ __forceinline__ void operator()(int64_t g, int, int64_t, int,
                                             float2 v) const {
    if (out_r)
      out_r[g] = __fdiv_rn(v.x, n);
    else
      out_c[g] = make_float2(__fdiv_rn(v.x, n), __fdiv_rn(v.y, n));
  }
  // The small-extent path's store: the float64 value divided by n in
  // float64, then rounded once to float.
  __device__ __forceinline__ void wide(int64_t g, double2 v) const {
    const double d = n;
    if (out_r)
      out_r[g] = __double2float_rn(v.x / d);
    else
      out_c[g] = make_float2(__double2float_rn(v.x / d), __double2float_rn(v.y / d));
  }
};

// The direction of a kernel: the inverse for InvStore, else the forward.
template <class Epi>
constexpr bool is_inverse = false;
template <>
constexpr bool is_inverse<InvStore> = true;

// The generic tile along the contiguous axis of (B, n): real (xr, forward
// only) or complex (xc) input; a block takes T rows.
template <class Pre, class Epi>
__global__ void __launch_bounds__(kThreads)
tile_lanes_kernel(const float* __restrict__ xr, const float2* __restrict__ xc,
                  const float2* __restrict__ tw_g, Plan p, int64_t B, Pre pre,
                  Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
  extern __shared__ float2 smem[];
  const int n = p.n, E = n * p.T;
  float2* a = smem;
  float2* c = smem + E;
  float2* tw = smem + 2 * E;
  const int64_t row0 = (int64_t)blockIdx.x * p.T;
  const int64_t base = row0 * n;
  load_table(tw, tw_g, n);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i / n, k = i % n;
    float2 v = make_float2(0.f, 0.f);
    if (row0 + l < B)
      v = xr ? make_float2(pre(xr[base + i]), 0.f) : xc[base + i];
    a[l * n + (INV ? true_k(k, p) : k)] = v;
  }
  __syncthreads();
  const float2* res = tile_fft<true, INV>(a, c, tw, p);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i / n, k = i % n;
    if (row0 + l < B)
      epi(base + i, k, row0 + l, 0, res[l * n + (INV ? k : true_k(k, p))]);
  }
}

// The generic tile along axis 1 of (P, n, L): blockIdx.y picks the prefix
// batch, blockIdx.x a run of T columns.  Real (xr, forward only) or complex
// (xc) input.
template <class Epi>
__global__ void __launch_bounds__(kThreads)
tile_sublanes_kernel(const float* __restrict__ xr,
                     const float2* __restrict__ xc,
                     const float2* __restrict__ tw_g, Plan p, int64_t L,
                     Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
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
    a[(INV ? true_k(k, p) : k) * T + l] = v;
  }
  __syncthreads();
  const float2* res = tile_fft<false, INV>(a, c, tw, p);
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int l = i % T, k = i / T;
    const int64_t col = col0 + l;
    if (col < L)
      epi(base + (int64_t)k * L + col, k, col, (int)blockIdx.y,
          res[(INV ? k : true_k(k, p)) * T + l]);
  }
}

// ---------------------------------------------------------------------------
// Register-resident kernels for n = 128, 256, 512, 1024 (b = 128)
// ---------------------------------------------------------------------------

constexpr int kRegSlots = 3;           // tiles in the cp.async ring
constexpr int kRegLanesThreads = 512;  // a lanes block: 512 / (N/8) rows a tile
constexpr int kRegLanesElems = kRegLanesThreads * 8;  // values of a lanes tile
constexpr int kRegDevices = 64;        // devices the resident-block cache keeps
constexpr int kRegCluster = 8;         // strided-axis blocks that walk in step

// The Stockham radices of N: 8, 8, then 2 (N = 128), 4 (256), 8 (512) or
// 8, 2 (1024), as make_plan orders them.
__host__ __device__ constexpr int reg_nstages(int N) { return N == 1024 ? 4 : 3; }
__host__ __device__ constexpr int reg_radix(int N, int s) {
  return s < 2 ? 8 : s == 3 ? 2 : N == 128 ? 2 : N == 256 ? 4 : 8;
}
// Ns: the product of the radices before stage s
__host__ __device__ constexpr int reg_ns(int N, int s) {
  return s == 0 ? 1 : reg_ns(N, s - 1) * reg_radix(N, s - 1);
}
// where stage s's (R-1)*Ns twiddles start in the per-stage table (s >= 1);
// reg_tw_off(N, reg_nstages(N)) is the table's size
__host__ __device__ constexpr int reg_tw_off(int N, int s) {
  return s <= 1 ? 0
                : reg_tw_off(N, s - 1) + (reg_radix(N, s - 1) - 1) * reg_ns(N, s - 1);
}
// columns of a strided-axis tile: C * N/8 threads, at most 1024
__host__ __device__ constexpr int reg_cols(int N) { return N <= 256 ? 32 : 8192 / N; }
// threads of a strided-axis block
__host__ __device__ constexpr int reg_sublanes_threads(int N) { return reg_cols(N) * (N / 8); }

inline bool reg_path(int64_t n, int64_t b) {
  return b == 128 && (n == 128 || n == 256 || n == 512 || n == 1024);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Exchange-buffer index of position p.  A lanes row is XOR-swizzled so that
// each half-warp's puts and gets of every stage hit 16 distinct 8-byte bank
// pairs; a strided-axis tile keeps its C columns contiguous, and at C = 8 a
// half-warp spans two positions, whose parity the bit p/8 separates.
template <bool LANES, int C>
__device__ __forceinline__ int xb_at(int p, int c) {
  if (LANES) return p ^ ((p >> 4) & 7) ^ (((p >> 6) & 1) << 3);
  return (C < 16 ? p ^ ((p >> 3) & 1) : p) * C + c;
}

// Stage s's butterflies on the thread's 8 values: butterfly j = t + T*m
// holds x[j + q*N/R] in v[m*R + q]; twiddle W_N^{-+q*(j mod Ns)*N/(Ns*R)}
// from the per-stage table (none at s = 0), then DFT_R, forward or inverse.
template <int N, int s, bool INV>
__device__ __forceinline__ void reg_butterflies(float2 (&v)[8],
                                                const float2* stw, int t) {
  constexpr int R = reg_radix(N, s), Ns = reg_ns(N, s), T = N / 8;
  const float2* w = stw + reg_tw_off(N, s);
#pragma unroll
  for (int m = 0; m < 8 / R; ++m) {
    const int jl = (t + T * m) & (Ns - 1);
    float2 u[R];
#pragma unroll
    for (int q = 0; q < R; ++q)
      u[q] = (s == 0 || q == 0) ? v[m * R + q]
                                : cmul(v[m * R + q], w[(q - 1) * Ns + jl]);
    dft<R, INV>(u);
#pragma unroll
    for (int q = 0; q < R; ++q) v[m * R + q] = u[q];
  }
}

// Stage s's outputs to their Stockham places (j/Ns)*Ns*R + j mod Ns + u*Ns.
template <int N, int s, bool LANES, int C>
__device__ __forceinline__ void reg_put(const float2 (&v)[8], float2* xb,
                                        int t, int c) {
  constexpr int R = reg_radix(N, s), Ns = reg_ns(N, s), T = N / 8;
#pragma unroll
  for (int m = 0; m < 8 / R; ++m) {
    const int j = t + T * m;
    const int o = (j / Ns) * Ns * R + (j & (Ns - 1));
#pragma unroll
    for (int u = 0; u < R; ++u) xb[xb_at<LANES, C>(o + u * Ns, c)] = v[m * R + u];
  }
}

// Stage s's inputs x[j + q*N/R].
template <int N, int s, bool LANES, int C>
__device__ __forceinline__ void reg_get(float2 (&v)[8], const float2* xb,
                                        int t, int c) {
  constexpr int R = reg_radix(N, s), T = N / 8;
#pragma unroll
  for (int m = 0; m < 8 / R; ++m)
#pragma unroll
    for (int q = 0; q < R; ++q)
      v[m * R + q] = xb[xb_at<LANES, C>(t + T * m + q * (N / R), c)];
}

// Stages s, s+1, ...: each exchanges the previous stage's outputs through xb
// and runs its butterflies.  The barrier before a put keeps it clear of the
// previous get (for s = 1, of the reads of the tile that xb holds).
template <int N, int s, bool LANES, int C, bool INV>
__device__ __forceinline__ void reg_stages(float2 (&v)[8], float2* xb,
                                           const float2* stw, int t, int c) {
  if constexpr (s < reg_nstages(N)) {
    __syncthreads();
    reg_put<N, s - 1, LANES, C>(v, xb, t, c);
    __syncthreads();
    reg_get<N, s, LANES, C>(v, xb, t, c);
    reg_butterflies<N, s, INV>(v, stw, t);
    reg_stages<N, s + 1, LANES, C, INV>(v, xb, stw, t, c);
  }
}

// The whole transform of the 8 values a thread read: the first stage in
// registers, then the exchanges through xb (a lanes row, or a strided tile
// of C columns).  The inverse is the same stages with DFT_R inverted; the
// host hands it the conjugate table.
template <int N, bool LANES, int C, bool INV>
__device__ __forceinline__ void reg_fft(float2 (&v)[8], float2* xb,
                                        const float2* stw, int t, int c) {
  reg_butterflies<N, 0, INV>(v, stw, t);
  reg_stages<N, 1, LANES, C, INV>(v, xb, stw, t, c);
}

// The slot k' = (k mod r) * 128 + k / r, r = N/128, that holds natural
// index k in the permuted order (true_k_order's inverse).
template <int N>
__device__ __forceinline__ int reg_slot(int k) {
  constexpr int r = N / 128;
  return (k % r) * 128 + k / r;
}

// Where thread t's input q, x[t + T*q], lies along the transform: in place
// for the forward, at its permuted slot for the inverse.
template <int N, bool INV>
__device__ __forceinline__ int reg_in(int t, int q) {
  const int k = t + (N / 8) * q;
  return INV ? reg_slot<N>(k) : k;
}

// Where thread t's output i goes along the transform.  After the last
// stage (radix R) value i = m*R + u is index k = t + T*m + (N/R)*u: the
// forward stores it to its permuted slot, the inverse in natural order.
template <int N, bool INV>
__device__ __forceinline__ int reg_out(int t, int i) {
  constexpr int R = reg_radix(N, reg_nstages(N) - 1);
  const int k = t + (N / 8) * (i / R) + (N / R) * (i % R);
  return INV ? k : reg_slot<N>(k);
}

// Where element e of a lanes tile sits in its ring slot.  The inverse's
// reads of row position k' = (t mod r)*128 + t/r + 16q (r = N/128) would
// put a half-warp on 16/r bank pairs; XOR-ing bits 4 - log2(r) .. 3 of e
// with (e >> 7) mod r, that is with t mod r, spreads them over 16.  Bit 0
// stays, so each 16-byte copy (a pair e, e + 1) lands whole.
template <int N, bool INV>
__device__ __forceinline__ int reg_lanes_at(int e) {
  constexpr int r = N / 128, shift = r == 2 ? 3 : r == 4 ? 2 : 1;
  return INV ? e ^ (((e >> 7) & (r - 1)) << shift) : e;
}

// The per-stage twiddle table, [q-1][j mod Ns] for each stage s >= 1.
template <int N, int s = 1>
__device__ __forceinline__ void reg_load_table(float2* stw,
                                               const float2* __restrict__ tw_g) {
  if constexpr (s < reg_nstages(N)) {
    constexpr int R = reg_radix(N, s), Ns = reg_ns(N, s), off = reg_tw_off(N, s);
    for (int i = threadIdx.x; i < (R - 1) * Ns; i += blockDim.x)
      stw[off + i] = tw_g[(i / Ns + 1) * (i % Ns) * (N / (Ns * R))];
    reg_load_table<N, s + 1>(stw, tw_g);
  }
}

template <int N>
constexpr size_t reg_smem(int tile_elems) {
  return (kRegSlots * (size_t)tile_elems + reg_tw_off(N, reg_nstages(N))) *
         sizeof(float2);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// The two halves of a barrier over the blocks of a cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The ring: kRegSlots tiles of E complex values in shared memory.  Tile i
// of a block lands in slot i mod kRegSlots; while a tile's butterflies run,
// the copies of the next kRegSlots - 1 tiles are in flight.  The exchange
// buffer of a tile is its own slot, once the slot has been read; the slot
// is refilled only after the barrier that opens the next tile.  Each
// iteration commits one cp.async group (empty past the last tile), so
// waiting for all but the newest kRegSlots - 2 groups waits for this tile.
//
// The copies of lanes tile `tile` (G = 512/(N/8) consecutive rows of (B, N),
// reals or complex values) into `dst`, 16 bytes each where the input is
// 16-byte aligned, else one value each, each to its place reg_lanes_at;
// rows past B are not read.  Commits one group.
template <int N, bool INV>
__device__ __forceinline__ void reg_lanes_fetch(float2* dst,
                                                const float* __restrict__ xr,
                                                const float2* __restrict__ xc,
                                                int64_t B, int64_t tile,
                                                int64_t tiles) {
  constexpr int E = kRegLanesElems;
  const bool real = xr != nullptr;
  if (tile < tiles) {
    const int64_t base = tile * E, end = B * N;
    if (aligned16(real ? (const void*)xr : xc)) {
      const int per = real ? 4 : 2;  // values a 16-byte copy
      char* d = reinterpret_cast<char*>(dst);
      const char* src = real ? (const char*)(xr + base) : (const char*)(xc + base);
      for (int e = threadIdx.x * per; e < E; e += kRegLanesThreads * per) {
        if (base + e >= end) break;
        cp_async<16>(d + (size_t)reg_lanes_at<N, INV>(e) * (16 / per),
                     src + (size_t)e * (16 / per));
      }
    } else {
#pragma unroll
      for (int e = threadIdx.x; e < E; e += kRegLanesThreads) {
        if (base + e >= end) break;
        if (real)
          cp_async<4>(reinterpret_cast<float*>(dst) + e, xr + base + e);
        else
          cp_async<8>(dst + reg_lanes_at<N, INV>(e), xc + base + e);
      }
    }
  }
  cp_async_commit();
}

// Thread t's 8 values x[t + q*N/8] of row g of the lanes tile held in
// `slot` (floats when real, forward only), through `pre` when real.
template <int N, bool INV, class Pre>
__device__ __forceinline__ void reg_lanes_read(float2 (&v)[8],
                                               const float2* slot, bool real,
                                               int g, int t, Pre pre) {
  if (real) {
    const float* src = reinterpret_cast<const float*>(slot) + g * N;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = make_float2(pre(src[reg_in<N, INV>(t, q)]), 0.f);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = slot[reg_lanes_at<N, INV>(g * N + reg_in<N, INV>(t, q))];
  }
}

// The copies of strided-axis tile `tile` (C = reg_cols(N) consecutive columns
// of one prefix batch of (P, N, L), ncols tiles a batch) into `dst`, laid out
// [position][column]: 16 bytes each where the input is 16-byte aligned and L
// keeps every row so, else one value each; columns past L are not read.
// Commits one group.
template <int N>
__device__ __forceinline__ void reg_sublanes_fetch(
    float2* dst, const float* __restrict__ xr, const float2* __restrict__ xc,
    int64_t L, int64_t ncols, int64_t tile, int64_t tiles) {
  constexpr int C = reg_cols(N), E = N * C, THREADS = reg_sublanes_threads(N);
  const bool real = xr != nullptr;
  if (tile < tiles) {
    const int64_t prefix = tile / ncols, col0 = (tile - prefix * ncols) * C;
    const int64_t base = prefix * N * L + col0;
    const int per = real ? 4 : 2;  // values a 16-byte copy
    if (L % per == 0 && aligned16(real ? (const void*)xr : xc)) {
      const int esize = real ? 4 : 8;
      char* d = reinterpret_cast<char*>(dst);
      const char* src = real ? (const char*)(xr + base) : (const char*)(xc + base);
      for (int e = threadIdx.x * per; e < E; e += THREADS * per) {
        const int p = e / C, cc = e % C;
        if (col0 + cc >= L) continue;
        cp_async<16>(d + (size_t)e * esize, src + ((int64_t)p * L + cc) * esize);
      }
    } else {
#pragma unroll
      for (int e = threadIdx.x; e < E; e += THREADS) {
        const int p = e / C, cc = e % C;
        if (col0 + cc >= L) continue;
        if (real)
          cp_async<4>(reinterpret_cast<float*>(dst) + e,
                      xr + base + (int64_t)p * L + cc);
        else
          cp_async<8>(dst + e, xc + base + (int64_t)p * L + cc);
      }
    }
  }
  cp_async_commit();
}

// Thread (t, c)'s 8 values x[t + q*N/8] of column c of the strided tile
// held in `slot` (floats when real, forward only).  A half-warp reads one
// position of 16 columns (at C = 8, two), whatever the position.
template <int N, bool INV>
__device__ __forceinline__ void reg_sublanes_read(float2 (&v)[8],
                                                  const float2* slot, bool real,
                                                  int t, int c) {
  constexpr int C = reg_cols(N);
  if (real) {
    const float* src = reinterpret_cast<const float*>(slot);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = make_float2(src[reg_in<N, INV>(t, q) * C + c], 0.f);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = slot[reg_in<N, INV>(t, q) * C + c];
  }
}

// The contiguous axis of (B, N), forward or inverse by `epi`: a tile is
// G = 512/(N/8) consecutive rows; row g of the tile goes to threads g*T ..
// g*T + T-1.  A persistent block walks the tiles; rows past B are neither
// read nor written.  `pre` maps each real input as it is read.
template <int N, class Pre, class Epi>
__global__ void __launch_bounds__(kRegLanesThreads, 2)
reg_lanes_kernel(const float* __restrict__ xr, const float2* __restrict__ xc,
                 const float2* __restrict__ tw_g, int64_t B, int64_t tiles,
                 Pre pre, Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
  constexpr int T = N / 8, G = kRegLanesThreads / T, E = kRegLanesElems;
  extern __shared__ float2 smem[];
  float2* ring = smem;  // kRegSlots tiles of E values (floats when real)
  float2* stw = smem + kRegSlots * E;
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  const int64_t step = gridDim.x;
  reg_load_table<N>(stw, tw_g);
  int64_t tile = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kRegSlots - 1; ++s)
    reg_lanes_fetch<N, INV>(ring + s * E, xr, xc, B, tile + s * step, tiles);
  for (int it = 0; tile < tiles; ++it, tile += step) {
    cp_async_wait<kRegSlots - 2>();
    __syncthreads();
    reg_lanes_fetch<N, INV>(ring + (it + kRegSlots - 1) % kRegSlots * E, xr, xc,
                            B, tile + (kRegSlots - 1) * step, tiles);
    float2* slot = ring + it % kRegSlots * E;
    float2 v[8];
    reg_lanes_read<N, INV>(v, slot, xr != nullptr, g, t, pre);
    reg_fft<N, true, 1, INV>(v, slot + g * N, stw, t, 0);
    const int64_t r = tile * G + g;
    if (r < B) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = reg_out<N, INV>(t, i);
        epi(r * N + k, k, r, 0, v[i]);
      }
    }
  }
}

// Axis 1 of (P, N, L), forward or inverse by `epi`: a tile is C =
// reg_cols(N) consecutive columns of one prefix batch; thread (t, c) =
// threadIdx (x / C, x % C), so neighbouring threads read, and hand to
// `epi`, neighbouring columns.  Columns past L are neither read nor handed
// on.
//
// The grid is made of clusters of CL = reg_cluster<Epi> blocks.  Block b
// takes tiles b, b + grid, ..., so the blocks of a cluster hold adjacent
// tiles, and a split cluster barrier a tile keeps them in step: the DRAM
// then sees CL * C columns of each row at once, not C (128 B at n = 512).
// With the plain store (kernel 3) at n = 512 that took the kernel from
// 0.825-0.839 ms to 0.790-0.794 at (1, 512, 262144), where rows are 2 MB
// apart, and from 0.796-0.814 to 0.735-0.739 at 512^3 (fft_probe.py before
// and after, NVIDIA H100 80GB HBM3, 700.00 W); the inverse store (kernel 4)
// takes them too (PERF.md section 6).  The k-space update's
// epilogues (kernels 5-6) read two more streams of their own, not through
// the ring, and ran slower in clusters of 8, so they keep clusters of one
// (PERF.md section 6).  Every block of a cluster runs as many iterations
// as its first block, so the barriers pair up; tiles past the last are
// neither read nor handed on.
template <class Epi>
constexpr int reg_cluster = 1;
template <>
constexpr int reg_cluster<Store> = kRegCluster;
template <>
constexpr int reg_cluster<InvStore> = kRegCluster;

template <int N, class Epi>
__global__ void __launch_bounds__(reg_sublanes_threads(N),
                                  1024 / reg_sublanes_threads(N))
reg_sublanes_kernel(const float* __restrict__ xr,
                    const float2* __restrict__ xc,
                    const float2* __restrict__ tw_g, int64_t L, int64_t ncols,
                    int64_t tiles, Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
  constexpr int C = reg_cols(N), E = N * C, CL = reg_cluster<Epi>;
  extern __shared__ float2 smem[];
  float2* ring = smem;
  float2* stw = smem + kRegSlots * E;
  const int c = threadIdx.x % C, t = threadIdx.x / C;
  const int64_t step = gridDim.x, lead = blockIdx.x - blockIdx.x % CL;
  reg_load_table<N>(stw, tw_g);
  int64_t tile = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kRegSlots - 1; ++s)
    reg_sublanes_fetch<N>(ring + s * E, xr, xc, L, ncols, tile + s * step, tiles);
  int it = 0;
  for (; lead + it * step < tiles; ++it, tile += step) {
    cp_async_wait<kRegSlots - 2>();
    __syncthreads();
    if (it > 0) cluster_wait();
    reg_sublanes_fetch<N>(ring + (it + kRegSlots - 1) % kRegSlots * E, xr, xc,
                          L, ncols, tile + (kRegSlots - 1) * step, tiles);
    cluster_arrive();
    float2* slot = ring + it % kRegSlots * E;
    float2 v[8];
    reg_sublanes_read<N, INV>(v, slot, xr != nullptr, t, c);
    reg_fft<N, false, C, INV>(v, slot, stw, t, c);
    const int64_t prefix = tile / ncols;
    const int64_t col = (tile - prefix * ncols) * C + c;
    if (tile < tiles && col < L) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = reg_out<N, INV>(t, i);
        epi((prefix * N + k) * L + col, k, col, (int)prefix, v[i]);
      }
    }
  }
  if (it > 0) cluster_wait();
}

// Launches a persistent kernel on clusters of `cluster` blocks: as many
// whole clusters as are resident on the card at once, or as the tiles need
// (each cluster gets at least one).  `resident` is the kernel's cache of
// that block count by device (0 until its first launch there); the
// shared-memory limit is set on that first launch too.
template <class... Params, class... Args>
cudaError_t reg_launch(void (*kernel)(Params...), int threads, size_t smem,
                       int cluster, int64_t tiles, int (&resident)[kRegDevices],
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kRegDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int clusters = 0;
    e = allow_smem(kernel, smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = clusters * cluster;
  }
  const int64_t need = (tiles + cluster - 1) / cluster * cluster;
  cfg.gridDim = dim3((unsigned)(need < resident[dev] ? need : resident[dev]));
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int N, class Pre, class Epi>
cudaError_t launch_reg_lanes(const float* xr, const float2* xc,
                             const float2* tw, int64_t B, cudaStream_t stream,
                             Pre pre, Epi epi) {
  constexpr int G = kRegLanesThreads / (N / 8);
  static int resident[kRegDevices];
  const int64_t tiles = (B + G - 1) / G;
  return reg_launch(reg_lanes_kernel<N, Pre, Epi>, kRegLanesThreads,
                    reg_smem<N>(kRegLanesElems), 1, tiles, resident, stream,
                    xr, xc, tw, B, tiles, pre, epi);
}

template <int N, class Epi>
cudaError_t launch_reg_sublanes(const float* xr, const float2* xc,
                                const float2* tw, int64_t P, int64_t L,
                                cudaStream_t stream, Epi epi) {
  constexpr int C = reg_cols(N);
  static int resident[kRegDevices];
  const int64_t ncols = (L + C - 1) / C;
  return reg_launch(reg_sublanes_kernel<N, Epi>, reg_sublanes_threads(N),
                    reg_smem<N>(N * C), reg_cluster<Epi>, P * ncols, resident,
                    stream, xr, xc, tw, L, ncols, P * ncols, epi);
}

// ---------------------------------------------------------------------------
// Small-extent kernels for every extent with b = n but 128 (n = 8 .. 400)
// ---------------------------------------------------------------------------
//
// At b = n the spectrum is in natural order (r = 1: true_k is the identity),
// so each kernel computes one plain DFT along its axis, the JAX package's
// direct DFT matmul (marlin_tpu/pallas_fft.py:52-67).  Benchmark 1a runs them
// at n = 200 on (200, 200) and (1, 200, 200): 200 transforms of 1.6 kB a
// pass, bound neither by bytes (0.14-0.48 us at 3.35 TB/s) nor by operations
// (7.6 kflop a transform), but by latency.  The generic tile gave each of 10
// blocks 20 transforms and ran 24-27 us a launch on an NVIDIA H100 80GB
// HBM3 (700 W), its stages serial behind block barriers, with runtime
// division and modulo in every index (PERF.md section 6).  Here one warp owns one transform, so that 200 transforms are
// 200 warps: a lanes block takes G = blockDim.x/32 rows (2: 100 blocks at
// 1a), a strided-axis block C = blockDim.x/32 adjacent columns (4, 32 bytes
// of each row: 50 blocks at 1a).  A block first fetches, by cp.async in one
// group, the host-built plan (from L2) and its input tile (from DRAM), so the
// two latencies overlap; each warp then widens its transform to float64 in
// shared memory and runs a mixed-radix Stockham FFT there, its stages apart
// by __syncwarp only, in the plan's order (odd primes first, then 2, 4, 8),
// the radices 2-8 as float64 butterflies in registers (dft), two a lane at
// a time, a prime above 7 summed directly over its roots.  Each output is rounded to float once, on its way to the
// epilogue (small_emit; InvStore divides by n in float64 first), so the
// result is within about one rounding of the correctly rounded DFT of the
// float32 input: the non-DC modes no longer leak into the mean through
// float32 twiddles, which is what drifted benchmark 1a's mass (ROADMAP
// section 3).  A stage's index j/Ns is (j + 1/2) times the host's float 1/Ns,
// rounded down: exact for j, Ns < 2^12, no division in the loops.
//
// The plan (unordered_fft.py small_plan, one per extent and direction,
// uploaded once a device) is 16-byte aligned:
//   int32 words 0-3: n, stages, inverse, twiddles;
//   words 4 + 5s ..: stage s's radix R, Ns (the product of the radices
//     before it), nb = n/R, its first twiddle (a double2 index from the
//     plan's start), the bits of float(1/Ns);
//   from byte 256, double2: each stage's (R-1) Ns twiddles
//     W_{Ns R}^{-+q j}, [q-1][j], and after them, for a prime R > 7, its R
//     roots W_R^{-+m} (the conjugates for the inverse).
// Its size is small_plan_bytes(n): n - 1 stage twiddles and the roots.

constexpr int kSmallMaxN = 400;         // unordered_fft.py DIRECT_MAX
constexpr int kSmallHeaderBytes = 256;  // the plan's int32 header
constexpr int kSmallStageWords = 5;     // R, Ns, nb, first twiddle, 1/Ns
constexpr int kSmallMaxWarps = 8;       // transforms a block, at most
constexpr int kSmallRows = 2;           // rows of a lanes block
constexpr int kSmallCols = 4;           // columns of a strided-axis block

inline bool small_path(int64_t n, int64_t b) {
  return b == n && n >= 8 && n <= kSmallMaxN && !reg_path(n, b);
}

// The plan's bytes at extent n: the header, n - 1 stage twiddles and, for
// each prime factor p > 7 of n (with multiplicity), its p roots.
inline int small_plan_bytes(int64_t n) {
  int64_t m = n, roots = 0;
  for (int p = 2; p <= 7; ++p)
    while (m % p == 0) m /= p;
  for (int64_t p = 11; m > 1; p += 2)
    while (m % p == 0) {
      roots += p;
      m /= p;
    }
  return kSmallHeaderBytes + 16 * (int)(n - 1 + roots);
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory of a block of `warps` transforms: the plan, the input as
// fetched (a lanes block's rows back to back; a strided-axis block's tile
// [position][column], C + 1 values a position) and two float64 buffers of n
// a warp, 2n + 1 apart.
inline size_t small_smem_bytes(int64_t n, int warps, bool sublanes) {
  const int staged = sublanes ? (int)n * (warps + 1) * 8 : warps * (int)n * 8;
  return small_plan_bytes(n) + round16(staged) + (size_t)warps * (2 * n + 1) * 16;
}

// cp.async copies of `words` 32-bit words from global src to shared dst,
// spread over the block: 16 bytes each where both are 16-byte aligned and
// words is a multiple of 4, else one word each.  The caller commits.
__device__ __forceinline__ void small_fetch(void* dst, const void* src, int words) {
  if (aligned16(src) && aligned16(dst) && (words & 3) == 0) {
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x)
      cp_async<16>(static_cast<char*>(dst) + 16 * i,
                   static_cast<const char*>(src) + 16 * i);
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      cp_async<4>(static_cast<uint32_t*>(dst) + i, static_cast<const uint32_t*>(src) + i);
  }
}

struct SmallStage {
  int R, Ns, nb;
  const double2* tw;  // [q-1][j mod Ns], then a prime's roots
  float rNs;          // float(1/Ns)
};

__device__ __forceinline__ SmallStage small_stage(const char* plan, int s) {
  const int* w = reinterpret_cast<const int*>(plan) + 4 + kSmallStageWords * s;
  return {w[0], w[1], w[2], reinterpret_cast<const double2*>(plan) + w[3],
          __int_as_float(w[4])};
}

// Butterfly j's j / Ns, by the float reciprocal (exact here, see above).
__device__ __forceinline__ int small_div(int j, float rNs) {
  return (int)__fmul_rn(__fadd_rn(__int2float_rn(j), 0.5f), rNs);
}

// H butterflies of one radix-R Stockham stage from lane j0 (j0 and j0 + 32
// when H = 2; the second a copy of the first, not stored, where `two` is
// false), so that their dependent float64 chains overlap: a block an SM has
// two or four warps, nothing else to hide latency.  Butterfly j reads a[j +
// q nb], takes twiddle (q-1) Ns + j mod Ns (none in a first stage, Ns = 1),
// runs DFT_R and writes c[(j/Ns) Ns R + j mod Ns + t Ns].
template <int R, bool INV, int H>
__device__ __forceinline__ void small_butterflies(const double2* a, double2* c,
                                                  const SmallStage& st, int j0,
                                                  bool two) {
  double2 u[H][R];
  int jl[H], out0[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = two ? j0 + 32 * h : j0;
    const int jh = small_div(j, st.rNs);
    jl[h] = j - jh * st.Ns;
    out0[h] = jh * st.Ns * R + jl[h];
#pragma unroll
    for (int q = 0; q < R; ++q) u[h][q] = a[j + q * st.nb];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (st.Ns > 1)
#pragma unroll
      for (int q = 1; q < R; ++q) u[h][q] = cmul(u[h][q], st.tw[(q - 1) * st.Ns + jl[h]]);
    dft<R, INV>(u[h]);
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (h == 0 || two)
#pragma unroll
      for (int t = 0; t < R; ++t) c[out0[h] + t * st.Ns] = u[h][t];
}

// One radix-R stage of the warp's transform, a -> c: butterflies j = lane,
// lane + 32, ..., two a lane at a time while the warp's first lane has two.
template <int R, bool INV>
__device__ __forceinline__ void small_radix(const double2* a, double2* c,
                                            const SmallStage& st, int lane) {
  int j0 = lane;
  for (; j0 - lane + 32 < st.nb; j0 += 64)
    small_butterflies<R, INV, 2>(a, c, st, j0, j0 + 32 < st.nb);
  if (j0 < st.nb) small_butterflies<R, INV, 1>(a, c, st, j0, false);
}

// A prime radix R > 7: every output of butterfly j summed directly, sum_q
// a[j + q nb] twiddle_q W_R^{-+qt}, the lanes taking t = lane, lane + 32, ...
// of one butterfly after another.
__device__ __forceinline__ void small_direct(const double2* a, double2* c,
                                             const SmallStage& st, int lane) {
  const int R = st.R;
  const double2* roots = st.tw + (R - 1) * st.Ns;
  for (int j = 0; j < st.nb; ++j) {
    const int jh = small_div(j, st.rNs), jl = j - jh * st.Ns;
    const int out0 = jh * st.Ns * R + jl;
    for (int t = lane; t < R; t += 32) {
      double2 acc = a[j];
      int m = t;  // q t mod R
      for (int q = 1; q < R; ++q) {
        const double2 v = cmul(a[j + q * st.nb], st.tw[(q - 1) * st.Ns + jl]);
        const double2 w = roots[m];
        acc.x = fma(v.x, w.x, fma(-v.y, w.y, acc.x));
        acc.y = fma(v.x, w.y, fma(v.y, w.x, acc.y));
        m += t;
        if (m >= R) m -= R;
      }
      c[out0 + t * st.Ns] = acc;
    }
  }
}

// Every stage of the warp's transform over its buffers a and c (the input
// in a); returns the one that holds the natural-order result.
template <bool INV>
__device__ __forceinline__ double2* small_fft(double2* a, double2* c,
                                              const char* plan, int lane) {
  const int stages = reinterpret_cast<const int*>(plan)[1];
  for (int s = 0; s < stages; ++s) {
    const SmallStage st = small_stage(plan, s);
    switch (st.R) {
      case 2: small_radix<2, INV>(a, c, st, lane); break;
      case 3: small_radix<3, INV>(a, c, st, lane); break;
      case 4: small_radix<4, INV>(a, c, st, lane); break;
      case 5: small_radix<5, INV>(a, c, st, lane); break;
      case 7: small_radix<7, INV>(a, c, st, lane); break;
      case 8: small_radix<8, INV>(a, c, st, lane); break;
      default: small_direct(a, c, st, lane);
    }
    __syncwarp();
    double2* t = a;
    a = c;
    c = t;
  }
  return a;
}

// An output of the small path to its epilogue, rounded once: the inverse's
// store divides by n in float64 (InvStore::wide), every other epilogue gets
// the value rounded to float2.
template <class Epi>
__device__ __forceinline__ void small_emit(const Epi& epi, int64_t g, int k,
                                           int64_t col, int prefix, double2 v) {
  if constexpr (is_inverse<Epi>)
    epi.wide(g, v);
  else
    epi(g, k, col, prefix, make_float2(__double2float_rn(v.x), __double2float_rn(v.y)));
}

__device__ __forceinline__ double2 widen(float2 v) { return make_double2(v.x, v.y); }

// A lanes block's fetch: the plan and its `rows` rows from row0, back to back
// in `staged`, in one cp.async group; then a block barrier.
__device__ __forceinline__ void small_lanes_fetch(char* plan, char* staged,
                                                  const void* plan_g, int plan_bytes,
                                                  const float* xr, const float2* xc,
                                                  int64_t row0, int rows, int n) {
  small_fetch(plan, plan_g, plan_bytes / 4);
  if (xr)
    small_fetch(staged, xr + row0 * n, rows * n);
  else
    small_fetch(staged, xc + row0 * n, 2 * rows * n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Warp w's row of the staged rows into its float64 buffer, reals through pre.
template <class Pre>
__device__ __forceinline__ void small_lanes_widen(double2* a, const char* staged,
                                                  bool real, int w, int n, int lane,
                                                  Pre pre) {
  if (real) {
    const float* src = reinterpret_cast<const float*>(staged) + w * n;
    for (int k = lane; k < n; k += 32) a[k] = make_double2(pre(src[k]), 0.0);
  } else {
    const float2* src = reinterpret_cast<const float2*>(staged) + w * n;
    for (int k = lane; k < n; k += 32) a[k] = widen(src[k]);
  }
  __syncwarp();
}

// The contiguous axis of (B, n), forward or inverse by `epi`: a block takes
// the G = blockDim.x/32 rows from blockIdx.x G, row w to warp w, which hands
// its outputs on in natural order, neighbouring lanes on neighbouring
// addresses.  `pre` maps each real input as it is widened.
template <class Pre, class Epi>
__global__ void __launch_bounds__(kSmallMaxWarps * 32)
small_lanes_kernel(const float* __restrict__ xr, const float2* __restrict__ xc,
                   const void* __restrict__ plan_g, int plan_bytes, int n,
                   int64_t B, Pre pre, Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
  extern __shared__ __align__(16) char small_smem[];
  const int G = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)blockIdx.x * G;
  const int rows = (int)(B - row0 < G ? B - row0 : G);
  char* staged = small_smem + plan_bytes;
  double2* a = reinterpret_cast<double2*>(staged + round16(G * n * 8)) + w * (2 * n + 1);
  small_lanes_fetch(small_smem, staged, plan_g, plan_bytes, xr, xc, row0, rows, n);
  if (w >= rows) return;
  small_lanes_widen(a, staged, xr != nullptr, w, n, lane, pre);
  const double2* res = small_fft<INV>(a, a + n, small_smem, lane);
  const int64_t r = row0 + w;
  for (int k = lane; k < n; k += 32) small_emit(epi, r * n + k, k, r, 0, res[k]);
}

// A strided-axis block's fetch: the plan and the tile of its `cols` columns
// from col0 of prefix batch base/(n L), [position][column] with C + 1 values
// a position, thread i fetching position i/C, column i mod C; one cp.async
// group, then a block barrier.
__device__ __forceinline__ void small_sublanes_fetch(char* plan, char* staged,
                                                     const void* plan_g, int plan_bytes,
                                                     const float* xr, const float2* xc,
                                                     int64_t base, int64_t col0, int cols,
                                                     int n, int64_t L, int C, int logC) {
  small_fetch(plan, plan_g, plan_bytes / 4);
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
    const int p = i >> logC, c = i & (C - 1);
    if (c >= cols) continue;
    const int64_t g = base + (int64_t)p * L + col0 + c;
    if (xr)
      cp_async<4>(reinterpret_cast<float*>(staged) + p * (C + 1) + c, xr + g);
    else
      cp_async<8>(reinterpret_cast<float2*>(staged) + p * (C + 1) + c, xc + g);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Warp w's column of the staged tile into its float64 buffer.
__device__ __forceinline__ void small_sublanes_widen(double2* a, const char* staged,
                                                     bool real, int w, int n, int C,
                                                     int lane) {
  if (real) {
    const float* src = reinterpret_cast<const float*>(staged);
    for (int p = lane; p < n; p += 32) a[p] = make_double2(src[p * (C + 1) + w], 0.0);
  } else {
    const float2* src = reinterpret_cast<const float2*>(staged);
    for (int p = lane; p < n; p += 32) a[p] = widen(src[p * (C + 1) + w]);
  }
  __syncwarp();
}

// Axis 1 of (P, n, L), forward or inverse by `epi`: block (x, y) takes the C =
// blockDim.x/32 adjacent columns from x C of prefix batch y, column w to warp
// w.  The outputs go to `epi` from thread i as position i/C, column i mod C,
// so each row's C values are written by neighbouring threads.  C is a power
// of two; columns past L are neither read nor handed on.
template <class Epi>
__global__ void __launch_bounds__(kSmallMaxWarps * 32)
small_sublanes_kernel(const float* __restrict__ xr, const float2* __restrict__ xc,
                      const void* __restrict__ plan_g, int plan_bytes, int n,
                      int64_t L, Epi epi) {
  constexpr bool INV = is_inverse<Epi>;
  extern __shared__ __align__(16) char small_smem[];
  const int C = blockDim.x >> 5, logC = __ffs(C) - 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 = (int64_t)blockIdx.x * C, base = (int64_t)blockIdx.y * n * L;
  const int cols = (int)(L - col0 < C ? L - col0 : C);
  char* staged = small_smem + plan_bytes;
  double2* bufs = reinterpret_cast<double2*>(staged + round16(n * (C + 1) * 8));
  small_sublanes_fetch(small_smem, staged, plan_g, plan_bytes, xr, xc, base, col0,
                       cols, n, L, C, logC);
  if (w < cols) {
    double2* a = bufs + w * (2 * n + 1);
    small_sublanes_widen(a, staged, xr != nullptr, w, n, C, lane);
    small_fft<INV>(a, a + n, small_smem, lane);
  }
  __syncthreads();
  // the result is in each warp's second buffer after an odd number of stages
  const int res = reinterpret_cast<const int*>(small_smem)[1] & 1 ? n : 0;
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
    const int k = i >> logC, c = i & (C - 1);
    if (c >= cols) continue;
    const int64_t col = col0 + c;
    small_emit(epi, base + (int64_t)k * L + col, k, col, (int)blockIdx.y,
               bufs[c * (2 * n + 1) + res + k]);
  }
}

// Raises `kernel`'s dynamic shared-memory limit on the current device to
// `bytes`, once per kernel, device and size: `allowed` is the launcher's
// record of what each device has been given.
template <class K>
cudaError_t allow_smem_once(K kernel, size_t bytes, size_t (&allowed)[kRegDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kRegDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  e = allow_smem(kernel, bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

// The small-extent kernels on `warps` transforms a block (small_path(n, n)
// must hold; `plan` is the extent's plan for the epilogue's direction).
template <class Pre, class Epi>
cudaError_t launch_small_lanes(const float* xr, const float2* xc, const void* plan,
                               int64_t B, int64_t n, int warps, cudaStream_t stream,
                               Pre pre, Epi epi) {
  static size_t allowed[kRegDevices];
  const size_t smem = small_smem_bytes(n, warps, false);
  const int64_t blocks = (B + warps - 1) / warps;
  if (warps < 1 || warps > kSmallMaxWarps || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem_once(small_lanes_kernel<Pre, Epi>, smem, allowed);
  if (e != cudaSuccess) return e;
  small_lanes_kernel<Pre, Epi><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      xr, xc, plan, small_plan_bytes(n), (int)n, B, pre, epi);
  return cudaGetLastError();
}

template <class Epi>
cudaError_t launch_small_sublanes(const float* xr, const float2* xc, const void* plan,
                                  int64_t P, int64_t n, int64_t L, int warps,
                                  cudaStream_t stream, Epi epi) {
  static size_t allowed[kRegDevices];
  const size_t smem = small_smem_bytes(n, warps, true);
  const int64_t blocks = (L + warps - 1) / warps;
  if (warps < 1 || warps > kSmallMaxWarps || (warps & (warps - 1)) ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem_once(small_sublanes_kernel<Epi>, smem, allowed);
  if (e != cudaSuccess) return e;
  small_sublanes_kernel<Epi><<<dim3((unsigned)blocks, (unsigned)P), warps * 32, smem,
                               stream>>>(xr, xc, plan, small_plan_bytes(n), (int)n, L,
                                         epi);
  return cudaGetLastError();
}

// The path the kernels of extent n (DFT size b) take: 1 the register
// kernels, 2 the small-extent kernels, 0 the generic tile.
inline int fft_path(int64_t n, int64_t b) {
  return reg_path(n, b) ? 1 : small_path(n, b) ? 2 : 0;
}

// Dynamic shared memory a block of the kernels takes at extent n (either
// direction): the register kernels' ring and stage table, the small-extent
// kernels' plan, input and buffers, or the generic tile.
template <int N>
constexpr size_t reg_smem_n(bool sublanes) {
  return reg_smem<N>(sublanes ? N * reg_cols(N) : kRegLanesElems);
}

inline size_t smem_bytes_n(int64_t n, int64_t b, bool sublanes) {
  if (reg_path(n, b)) {
    switch (n) {
      case 128: return reg_smem_n<128>(sublanes);
      case 256: return reg_smem_n<256>(sublanes);
      case 512: return reg_smem_n<512>(sublanes);
      case 1024: return reg_smem_n<1024>(sublanes);
    }
  }
  if (small_path(n, b))
    return small_smem_bytes(n, sublanes ? kSmallCols : kSmallRows, sublanes);
  Plan p;
  return make_plan(&p, n, b) ? smem_bytes(p) : 0;
}

// The register kernels by extent (reg_path(n, b) must hold).
template <class Pre, class Epi>
cudaError_t launch_reg_lanes_n(const float* xr, const float2* xc,
                               const float2* tw, int64_t B, int64_t n,
                               cudaStream_t stream, Pre pre, Epi epi) {
  switch (n) {
    case 128: return launch_reg_lanes<128>(xr, xc, tw, B, stream, pre, epi);
    case 256: return launch_reg_lanes<256>(xr, xc, tw, B, stream, pre, epi);
    case 512: return launch_reg_lanes<512>(xr, xc, tw, B, stream, pre, epi);
    case 1024: return launch_reg_lanes<1024>(xr, xc, tw, B, stream, pre, epi);
  }
  return cudaErrorInvalidValue;
}

template <class Epi>
cudaError_t launch_reg_sublanes_n(const float* xr, const float2* xc,
                                  const float2* tw, int64_t P, int64_t n,
                                  int64_t L, cudaStream_t stream, Epi epi) {
  switch (n) {
    case 128: return launch_reg_sublanes<128>(xr, xc, tw, P, L, stream, epi);
    case 256: return launch_reg_sublanes<256>(xr, xc, tw, P, L, stream, epi);
    case 512: return launch_reg_sublanes<512>(xr, xc, tw, P, L, stream, epi);
    case 1024: return launch_reg_sublanes<1024>(xr, xc, tw, P, L, stream, epi);
  }
  return cudaErrorInvalidValue;
}

// Host launchers along the contiguous axis of (B, n) and along axis 1 of
// (P, n, L), forward or inverse by `epi`, on the path fft_path(n, b) names:
// `tab` is the table the host built for it (unordered_fft.py _table: W_n^j
// as float2 for the register kernels and the tile, the small-extent plan).
// Each returns the launch's cudaGetLastError() (or cudaErrorInvalidValue for
// a shape the kernels do not take).
template <class Pre, class Epi>
cudaError_t launch_lanes(const float* xr, const float2* xc, const void* tab,
                         int64_t B, int64_t n, int64_t b, cudaStream_t stream,
                         Pre pre, Epi epi) {
  Plan p;
  if (B < 1 || !make_plan(&p, n, b)) return cudaErrorInvalidValue;
  const float2* tw = static_cast<const float2*>(tab);
  if (reg_path(n, b))
    return launch_reg_lanes_n(xr, xc, tw, B, n, stream, pre, epi);
  if (small_path(n, b))
    return launch_small_lanes(xr, xc, tab, B, n, kSmallRows, stream, pre, epi);
  static size_t allowed[kRegDevices];
  const size_t smem = smem_bytes(p);
  cudaError_t e = allow_smem_once(tile_lanes_kernel<Pre, Epi>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (B + p.T - 1) / p.T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  tile_lanes_kernel<Pre, Epi><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xc, tw, p, B, pre, epi);
  return cudaGetLastError();
}

template <class Epi>
cudaError_t launch_sublanes(const float* xr, const float2* xc, const void* tab,
                            int64_t P, int64_t n, int64_t L, int64_t b,
                            cudaStream_t stream, Epi epi) {
  Plan p;
  if (P < 1 || P > 65535 || L < 1 || !make_plan(&p, n, b))
    return cudaErrorInvalidValue;
  const float2* tw = static_cast<const float2*>(tab);
  if (reg_path(n, b))
    return launch_reg_sublanes_n(xr, xc, tw, P, n, L, stream, epi);
  if (small_path(n, b))
    return launch_small_sublanes(xr, xc, tab, P, n, L, kSmallCols, stream, epi);
  static size_t allowed[kRegDevices];
  const size_t smem = smem_bytes(p);
  cudaError_t e = allow_smem_once(tile_sublanes_kernel<Epi>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (L + p.T - 1) / p.T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)P);
  tile_sublanes_kernel<Epi><<<grid, kThreads, smem, stream>>>(xr, xc, tw, p, L,
                                                              epi);
  return cudaGetLastError();
}

}  // namespace
