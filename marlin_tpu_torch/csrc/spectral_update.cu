// The fused semi-implicit k-space update for Hopper (sm_90a): the last
// forward axis of mu-bar and the Adams-Bashforth-Moulton update in one pass.
//
//   mtt_fwd_x_update       <- marlin_tpu/pallas_spectral.py:120
//                             _fwd_x_update_kernel       (kernel 5)
//   mtt_fwd_x_update_poly  <- marlin_tpu/pallas_spectral.py:203
//                             _fwd_x_update_kernel_poly  (kernel 6)
//
// Both are the forward sublanes kernel of fft_tile.cuh over (P, n, L) with
// an epilogue in place of the store.  For each output slot k' (permuted
// order) and column l it rebuilds k^2 = kx2[k'] + kyz2[l] from the two 1-D
// tables of permuted |k|^2 (kx2 is indexed by the STORED slot k', since
// the transform permutes on the way out), reads u-bar and the old N-bar at
// the same place, and writes
//
//   N-bar = M-bar * mu-bar              (M-bar = -k^2 * mobility, or 1)
//   u-bar' = (u-bar + dt (b0 N-bar + b1 N-bar_old)) / (1 - dt L-bar)
//
// with L-bar = kappa k^4 ("lapsq") or r - alpha^2 (1 - k^2)^2 ("sh") in
// kernel 5, and the polynomials M-bar = m0 + m1 k^2, L-bar = la0 + la1 k^2
// + la2 k^4 read per field from the row [dt, b0, b1, m0, m1, la0, la1, la2]
// in kernel 6, whose fields are the prefix P of one launch (the TPU kernel
// is vmapped over them).  The operation order is the TPU kernel's:
// den = 1 / (1 - dt L-bar), then (u-bar + dt acc) * den.
//
// Bound: it reads mu-bar, u-bar and N-bar_old and writes u-bar' and N-bar,
// 5 x 8 bytes an element: 5.37 GB a field at 512^3, 1.60 ms at 3.35 TB/s.
// The FFT and the update come to about 5 n log2(n) / n + 25 flop an element
// (0.1 ms at 67 TFLOP/s), so the kernel is bound by bytes.  Its design
// saves the two passes over full complex grids that the unfused chain
// spends on N-bar = M-bar mu-bar and on the update, and reads each of the
// three inputs once.  The transform is the sublanes kernel's: at n = 128,
// 256, 512 and 1024 the register-resident kernel of fft_tile.cuh (a
// persistent block over C-column tiles brought in by a cp.async ring, not
// in the clusters kernel 3 takes, which made these epilogues slower; the
// epilogue called from registers with neighbouring threads on neighbouring
// columns, so the reads of u-bar, N-bar_old and kyz2 stay coalesced), at
// b = n (benchmark 1a's n = 200) the small-extent kernel of fft_tile.cuh
// (one warp a column, float64 stages, the epilogue called with each value
// rounded once, neighbouring threads on neighbouring columns), at n = 384,
// 640, 768, 896 the generic shared-memory tile.  `tw` is the table the host
// built for the path (unordered_fft.py _table).

#include "fft_tile.cuh"

namespace {

constexpr int kMaxFields = 16;

// Kernel 5's epilogue: L-bar is "sh" (SH) or "lapsq", and N-bar carries
// the mobility factor (MOB) or is mu-bar itself.  Both are template
// parameters, so a deck's kernel has no branch on them.
template <bool SH, bool MOB>
struct Update {
  const float2* ubar;
  const float2* nold;
  float2* u_out;
  float2* n_out;
  const float* kx2;
  const float* kyz2;
  float dt, b0, b1;
  float lin0, lin1;  // kappa (lapsq), or r and alpha^2 (sh)
  float mobility;

  __device__ __forceinline__ void operator()(int64_t g, int kp, int64_t col,
                                             int, float2 m) const {
    const float k2 = kx2[kp] + kyz2[col];
    float lb;
    if (SH) {
      const float om = 1.f - k2;
      lb = lin0 - lin1 * (om * om);
    } else {
      lb = (k2 * k2) * lin0;
    }
    float2 nv = m;
    if (MOB) {
      const float mb = -k2 * mobility;
      nv = make_float2(mb * m.x, mb * m.y);
    }
    const float2 o = nold[g];
    const float2 u = ubar[g];
    const float acc_r = b0 * nv.x + b1 * o.x;
    const float acc_i = b0 * nv.y + b1 * o.y;
    const float den = 1.f / (1.f - dt * lb);
    u_out[g] = make_float2((u.x + dt * acc_r) * den, (u.y + dt * acc_i) * den);
    n_out[g] = nv;
  }
};

// Kernel 6's epilogue: the coefficient row of field `f` (the prefix index).
struct PolyUpdate {
  const float2* ubar;
  const float2* nold;
  float2* u_out;
  float2* n_out;
  const float* kx2;
  const float* kyz2;
  float row[kMaxFields][8];  // dt, b0, b1, m0, m1, la0, la1, la2

  __device__ __forceinline__ void operator()(int64_t g, int kp, int64_t col,
                                             int f, float2 m) const {
    const float* r = row[f];
    const float dt = r[0], b0 = r[1], b1 = r[2];
    const float k2 = kx2[kp] + kyz2[col];
    const float lb = r[5] + r[6] * k2 + r[7] * (k2 * k2);
    const float mb = r[3] + r[4] * k2;
    const float2 nv = make_float2(mb * m.x, mb * m.y);
    const float2 o = nold[g];
    const float2 u = ubar[g];
    const float acc_r = b0 * nv.x + b1 * o.x;
    const float acc_i = b0 * nv.y + b1 * o.y;
    const float den = 1.f / (1.f - dt * lb);
    u_out[g] = make_float2((u.x + dt * acc_r) * den, (u.y + dt * acc_i) * den);
    n_out[g] = nv;
  }
};

}  // namespace

extern "C" {

// mu, ubar, nold, u_out, n_out: (n, L) complex; kx2: (n,) and kyz2: (L,)
// float, permuted |k|^2.  sh: L-bar form (0 lapsq, 1 sh); mob: 1 when
// N-bar = -k^2 * mobility * mu-bar, 0 when N-bar = mu-bar.
cudaError_t mtt_fwd_x_update(const void* mu, const void* ubar,
                             const void* nold, void* u_out, void* n_out,
                             const void* kx2, const void* kyz2, const void* tw,
                             int64_t n, int64_t L, int64_t b, int sh, int mob,
                             float dt, float b0, float b1, float lin0,
                             float lin1, float mobility, cudaStream_t stream) {
  const float2* m = (const float2*)mu;
  const float2* t = (const float2*)tw;
#define MTT_UPDATE(SH_, MOB_)                                              \
  launch_sublanes(                                                         \
      nullptr, m, t, 1, n, L, b, stream,                                   \
      Update<SH_, MOB_>{(const float2*)ubar, (const float2*)nold,          \
                        (float2*)u_out, (float2*)n_out, (const float*)kx2, \
                        (const float*)kyz2, dt, b0, b1, lin0, lin1,        \
                        mobility})
  if (sh) return mob ? MTT_UPDATE(true, true) : MTT_UPDATE(true, false);
  return mob ? MTT_UPDATE(false, true) : MTT_UPDATE(false, false);
#undef MTT_UPDATE
}

// mu, ubar, nold, u_out, n_out: (N, n, L) complex; rows: N x 8 floats in
// host memory, copied into the launch's arguments.
cudaError_t mtt_fwd_x_update_poly(const void* mu, const void* ubar,
                                  const void* nold, void* u_out, void* n_out,
                                  const void* kx2, const void* kyz2,
                                  const void* tw, int64_t N, int64_t n,
                                  int64_t L, int64_t b, const float* rows,
                                  cudaStream_t stream) {
  if (N < 1 || N > kMaxFields) return cudaErrorInvalidValue;
  PolyUpdate op{(const float2*)ubar, (const float2*)nold, (float2*)u_out,
                (float2*)n_out, (const float*)kx2, (const float*)kyz2, {}};
  for (int64_t f = 0; f < N; ++f)
    for (int j = 0; j < 8; ++j) op.row[f][j] = rows[f * 8 + j];
  return launch_sublanes(nullptr, (const float2*)mu, (const float2*)tw, N, n,
                         L, b, stream, op);
}

}  // extern "C"
