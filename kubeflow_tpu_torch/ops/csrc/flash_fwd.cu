// Flash-attention forward for Hopper (sm_90a): out and lse.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_flash_fwd`
// (kubeflow_tpu/ops/flash_attention.py). One CTA per (64-row q tile,
// q head, batch row); the k/v tiles the causal/window rules let it see
// stream through shared memory, and the online softmax (running max m,
// running sum l, output accumulator) stays in registers, as the TPU
// kernel keeps it in VMEM scratch across its sequential k grid axis.
//
// Bound: at the training shapes (L 2048, D 64) the two products are
// 4.L^2.D/2 FLOPs per (batch, head) against 4.L.D bytes of q/k/v/out,
// far above the card's ~295 FLOP/byte ridge: tensor-core bound. This
// first version uses mma.sync with plain shared-memory staging and no
// copy/compute overlap; wgmma, TMA and pipelining are later work.
#include "flash_common.cuh"

namespace kft {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashArgs a) {
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

  // this warp's 16 q rows, staged through ks
  load_tile<D>(ks, a.q + (static_cast<size_t>(b) * a.Lq + qb * kTile) * q_ld +
                       h * D, q_ld);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_frags<D>(qa, ks, r0, t);
  int qseg[2] = {0, 0};
  if (a.qseg) {
    qseg[0] = a.qseg[static_cast<size_t>(b) * a.Lq + qpos[0]];
    qseg[1] = a.qseg[static_cast<size_t>(b) * a.Lq + qpos[1]];
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const bf16* kbase = a.k + static_cast<size_t>(b) * a.Lk * kv_ld + hk * D;
  const bf16* vbase = a.v + static_cast<size_t>(b) * a.Lk * kv_ld + hk * D;
  const int nk = a.Lk / kTile;
  // _kb_lo: no block left of the window's reach can run
  const int kb_lo = (a.causal && a.window > 0)
                        ? max(0, floor_div(qb * kTile + offset - (a.window - 1),
                                           kTile))
                        : 0;
  for (int kb = kb_lo; kb < nk; ++kb) {
    if (!block_runs(a, qb, kb, offset)) continue;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(ks, kbase + static_cast<size_t>(kb) * kTile * kv_ld, kv_ld);
    load_tile<D>(vs, vbase + static_cast<size_t>(kb) * kTile * kv_ld, kv_ld);
    if (a.kseg && threadIdx.x < kTile)
      kseg_s[threadIdx.x] =
          a.kseg[static_cast<size_t>(b) * a.Lk + kb * kTile + threadIdx.x];
    __syncthreads();

    float s[kTile / 8][4];
    mma_rows<D>(s, qa, ks, g, t);

    float mc[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = n * 8 + t * 2 + (e & 1);
        const bool ok = pair_valid(a, qpos[i], kb * kTile + col, offset) &&
                        (!a.qseg || qseg[i] == kseg_s[col]);
        s[n][e] = ok ? s[n][e] * a.scale : kNegInf;
        mc[i] = fmaxf(mc[i], s[n][e]);
      }
    }
    float alpha[2], mn[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = fmaxf(m[i], quad_max(mc[i]));
      alpha[i] = __expf(m[i] - mn[i]);
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - mn[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
      m[i] = mn[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    mma_cols<D>(o, s, vs, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(l[i], 1e-20f);
    bf16* orow = a.out + (static_cast<size_t>(b) * a.Lq + qpos[i]) * q_ld +
                 h * D + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          o[n][2 * i] / li, o[n][2 * i + 1] / li);
    if (t == 0)
      a.lse_out[(static_cast<size_t>(b) * a.H + h) * a.Lq + qpos[i]] =
          m[i] + logf(li);
  }
}

}  // namespace kft

extern "C" {

const char* kft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t: the launch's own error, 0 when it was accepted.
int kft_flash_fwd(const void* q, const void* k, const void* v,
                  const void* qseg, const void* kseg, void* out, void* lse,
                  int B, int H, int Hkv, int Lq, int Lk, int D, float scale,
                  int causal, int window, void* stream) {
  using namespace kft;
  FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = static_cast<bf16*>(out);
  a.lse_out = static_cast<float*>(lse);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Lq = Lq; a.Lk = Lk;
  a.scale = scale; a.causal = causal; a.window = window;
  const dim3 grid(Lq / kTile, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(a);
  else if (D == 128)
    flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
