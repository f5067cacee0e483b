// Flash-attention backward for Hopper (sm_90a): dq.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (kubeflow_tpu/ops/
// flash_attention.py, launched from _flash_bwd_pallas). It recomputes
// p = exp(s - lse) from the forward's saved lse and forms
// ds = p * (dp - delta) * scale (`_recompute_p_ds`), with
// delta = rowsum(dO * O) computed by the caller, as on the TPU. The dk/dv
// kernel is flash_bwd_dkv.cu.
//
// dq: one CTA per (64-row q tile, q head, batch row), walking the k/v
// tiles the mask lets it see; dq accumulates in registers.
//
// Bound: three products of L^2.D/2 MACs each per (batch, head) under the
// causal mask (1.5x the forward) over ~5.L.D bytes: tensor-core bound,
// as the forward. mma.sync with plain staging, no overlap.
#include "flash_common.cuh"

namespace kft {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int LD = D + kPad;
  __shared__ __align__(16) bf16 ks[kTile * LD];
  __shared__ __align__(16) bf16 vs[kTile * LD];
  __shared__ int kseg_s[kTile];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = a.Lk - a.Lq;
  const size_t q_ld = static_cast<size_t>(a.H) * D;
  const size_t kv_ld = static_cast<size_t>(a.Hkv) * D;
  const int r0 = warp * 16 + g;
  const int qpos[2] = {qb * kTile + r0, qb * kTile + r0 + 8};
  const size_t q_off =
      (static_cast<size_t>(b) * a.Lq + qb * kTile) * q_ld + h * D;

  // q and dO fragments of this warp's rows, staged through ks / vs
  load_tile<D>(ks, a.q + q_off, q_ld);
  load_tile<D>(vs, a.dout + q_off, q_ld);
  __syncthreads();
  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_frags<D>(qa, ks, r0, t);
  load_frags<D>(ga, vs, r0, t);
  float lse[2], delta[2];
  int qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (static_cast<size_t>(b) * a.H + h) * a.Lq + qpos[i];
    lse[i] = a.lse[row];
    delta[i] = a.delta[row];
    if (a.qseg) qseg[i] = a.qseg[static_cast<size_t>(b) * a.Lq + qpos[i]];
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const bf16* kbase = a.k + static_cast<size_t>(b) * a.Lk * kv_ld + hk * D;
  const bf16* vbase = a.v + static_cast<size_t>(b) * a.Lk * kv_ld + hk * D;
  const int nk = a.Lk / kTile;
  const int kb_lo = (a.causal && a.window > 0)
                        ? max(0, floor_div(qb * kTile + offset - (a.window - 1),
                                           kTile))
                        : 0;
  for (int kb = kb_lo; kb < nk; ++kb) {
    if (!block_runs(a, qb, kb, offset)) continue;
    __syncthreads();
    load_tile<D>(ks, kbase + static_cast<size_t>(kb) * kTile * kv_ld, kv_ld);
    load_tile<D>(vs, vbase + static_cast<size_t>(kb) * kTile * kv_ld, kv_ld);
    if (a.kseg && threadIdx.x < kTile)
      kseg_s[threadIdx.x] =
          a.kseg[static_cast<size_t>(b) * a.Lk + kb * kTile + threadIdx.x];
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_rows<D>(s, qa, ks, g, t);   // q . k^T
    mma_rows<D>(dp, ga, vs, g, t);  // dO . v^T
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = n * 8 + t * 2 + (e & 1);
        const bool ok = pair_valid(a, qpos[i], kb * kTile + col, offset) &&
                        (!a.qseg || qseg[i] == kseg_s[col]);
        const float p = __expf((ok ? s[n][e] * a.scale : kNegInf) - lse[i]);
        s[n][e] = p * (dp[n][e] - delta[i]) * a.scale;  // ds
      }
    }
    mma_cols<D>(dq, s, ks, g, t);  // dq += ds . k
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = a.out + (static_cast<size_t>(b) * a.Lq + qpos[i]) * q_ld +
                h * D + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

static FlashArgs bwd_args(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          const void* qseg, const void* kseg, int B, int H,
                          int Hkv, int Lq, int Lk, float scale, int causal,
                          int window) {
  FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Lq = Lq; a.Lk = Lk;
  a.scale = scale; a.causal = causal; a.window = window;
  return a;
}

}  // namespace kft

extern "C" {

// Returns a cudaError_t: the launch's own error, 0 when it was accepted.
int kft_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* qseg, const void* kseg, void* dq, int B,
                     int H, int Hkv, int Lq, int Lk, int D, float scale,
                     int causal, int window, void* stream) {
  using namespace kft;
  FlashArgs a = bwd_args(q, k, v, dout, lse, delta, qseg, kseg, B, H, Hkv, Lq,
                         Lk, scale, causal, window);
  a.out = static_cast<bf16*>(dq);
  const dim3 grid(Lq / kTile, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    flash_bwd_dq_kernel<64><<<grid, kThreads, 0, st>>>(a);
  else if (D == 128)
    flash_bwd_dq_kernel<128><<<grid, kThreads, 0, st>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
