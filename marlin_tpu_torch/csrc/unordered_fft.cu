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
// natural-order real space divided by n.  The kernels and their launchers
// live in fft_tile.cuh, shared with the fused kernels; the direction
// follows the epilogue (Store forward, InvStore inverse), and the fused
// pointwise read of _fwd_lanes_kernel (`pre`) is the same forward lanes
// kernel instantiated with a generated functor (unordered_fft.py).
//
// Bound: at 512^3 a pass moves 1.6-2.1 GB, 0.48-0.64 ms at 3.35 TB/s; the
// FFT's 5*n*log2(n) flop a transform come to 6.0e9 a pass, 0.09 ms at
// 67 TFLOP/s, so it is bound by bytes.
// All four take the register-resident path of fft_tile.cuh for n = 128,
// 256, 512 and 1024 (a persistent block, a cp.async ring of tiles, 8
// values a thread, the exchanges in the tile's own ring slot; the forward
// stores straight to the permuted slot, the inverse reads from it and
// stores in natural order) and the generic shared-memory tile otherwise;
// the launchers choose by n (mtt_fwd_path and mtt_inv_path say which).

#include "fft_tile.cuh"

extern "C" {

// 1 when the forward (inverse) kernels of extent n (DFT size b) take the
// register path of fft_tile.cuh, 0 for the generic tile.
int mtt_fwd_path(int64_t n, int64_t b) { return reg_path(n, b) ? 1 : 0; }
int mtt_inv_path(int64_t n, int64_t b) { return reg_path(n, b) ? 1 : 0; }

// Bytes of dynamic shared memory a block of the lanes (sublanes = 0) or
// sublanes kernels of extent n takes, either direction; 0 for an extent
// they do not take.
int mtt_smem(int64_t n, int64_t b, int sublanes) {
  return (int)smem_bytes_n(n, b, sublanes != 0);
}

// x_real or x_cplx (the other null): (B, n); out: (B, n) complex.
cudaError_t mtt_fwd_lanes(const void* x_real, const void* x_cplx, void* out,
                          const void* tw, int64_t B, int64_t n, int64_t b,
                          cudaStream_t stream) {
  return launch_lanes((const float*)x_real, (const float2*)x_cplx,
                      (const float2*)tw, B, n, b, stream, Identity(),
                      Store{(float2*)out});
}

// x: (B, n) complex, permuted; out_real or out_cplx (the other null).
cudaError_t mtt_inv_lanes(const void* x, void* out_real, void* out_cplx,
                          const void* tw, int64_t B, int64_t n, int64_t b,
                          cudaStream_t stream) {
  return launch_lanes(nullptr, (const float2*)x, (const float2*)tw, B, n, b,
                      stream, Identity(),
                      InvStore{(float*)out_real, (float2*)out_cplx, (float)n});
}

// x_real or x_cplx (the other null): (P, n, L); out: (P, n, L) complex.
cudaError_t mtt_fwd_sublanes(const void* x_real, const void* x_cplx,
                             void* out, const void* tw, int64_t P, int64_t n,
                             int64_t L, int64_t b, cudaStream_t stream) {
  return launch_sublanes((const float*)x_real, (const float2*)x_cplx,
                         (const float2*)tw, P, n, L, b, stream,
                         Store{(float2*)out});
}

// x: (P, n, L) complex, permuted along n; out: (P, n, L) complex.
cudaError_t mtt_inv_sublanes(const void* x, void* out, const void* tw,
                             int64_t P, int64_t n, int64_t L, int64_t b,
                             cudaStream_t stream) {
  return launch_sublanes(nullptr, (const float2*)x, (const float2*)tw, P, n,
                         L, b, stream,
                         InvStore{nullptr, (float2*)out, (float)n});
}

}  // extern "C"
