// Flash-attention backward for Hopper (sm_90a): dq.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (kubeflow_tpu/ops/
// flash_attention.py, launched from _flash_bwd_pallas). It recomputes
// p = exp(s - lse) from the forward's saved lse and forms
// ds = p * (dp - delta) * scale (`_recompute_p_ds`), with
// delta = rowsum(dO * O) computed by the caller, as on the TPU, and
// accumulates dq = ds.k over the k tiles the mask lets a q tile see. The
// dk/dv kernel is flash_bwd_dkv.cu.
//
// Bound: three products of L^2.D/2 MACs each per (batch, head) under the
// causal mask (1.5x the forward) over ~5.L.D bytes: tensor-core bound,
// with one exp per 192 multiply-adds of products at D 64 and no max.
// Design, as flash_fwd.cu: a work item is one (128-row q tile, q head,
// batch row), heaviest causal tiles first, on a persistent grid of one
// CTA per SM. One producer thread loads the item's Q and dO tiles by TMA
// (resident for the whole walk, double-buffered across items) with
// their lse, delta and segment rows by bulk copy, and streams K and V
// tiles (and key segment ids) into a ring of shared-memory stages
// guarded by mbarriers. Two consumer warpgroups of 64 q rows each run
// S = Q.K^T and dP = dO.V^T as SS wgmma, form dS in registers rounded to
// bf16 (as the TPU kernel's ds.astype(k.dtype)), and accumulate
// dQ += dS.K as an RS wgmma with K read MN-major straight from the TMA
// tile. Interior tiles skip the per-element mask.
#include "flash_sm90.cuh"

namespace kft::sm90 {

template <int D>
struct DqTile {
  // KERNEL_TILES["flash_bwd_dq"]: at D 128, S, dP and dQ of 128 keys
  // would hold 192 f32 registers a thread, and two stages of 128-key K/V
  // beside the double-buffered Q and dO would not fit shared memory
  static constexpr int kBQ = 128, kBK = D == 64 ? 128 : 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBQ * D * 2;   // one of Q, dO
  static constexpr int kKVBytes = kBK * D * 2;  // one of K, V
  static constexpr int kRowBytes = kBQ * 4;     // one of lse, delta, qseg
  // shared memory: 2 x (Q | dO) | stages x (K | V) | 2 x (lse | delta |
  // qseg) | stages x kseg | barriers
  static constexpr int kKVOff = 4 * kQBytes;
  static constexpr int kRowOff = kKVOff + kStages * 2 * kKVBytes;
  static constexpr int kSegOff = kRowOff + 2 * 3 * kRowBytes;
  static constexpr int kBarOff = kSegOff + kStages * kBK * 4;
  static constexpr int kSmem = kBarOff + (2 * kStages + 4) * 8 + 1024;
};

// The first k tile at or after kb that _block_runs lets the q tile at q0
// see, or -1. Producer and consumers walk the same tiles through it.
template <int D>
__device__ __forceinline__ int dq_k_tile(const Args& a, int q0, int kb,
                                         int offset) {
  using T = DqTile<D>;
  for (; kb < a.Lk / T::kBK; ++kb)
    if (block_runs(a, q0, T::kBQ, kb * T::kBK, T::kBK, offset)) return kb;
  return -1;
}

// dS = P * (dP - delta) * scale in place in dp, with P = exp(S.scale -
// lse) (`_recompute_p_ds`): this thread's rows r (lse and delta.scale in
// log2 units lse2[r] and dsc[r]) against keys k0 + 8j + 2t + {0, 1}.
// kMasked applies the element rule of _block_mask with the -1e30 fill
// (key k0 + 2t + cc of row r lies at distance d0 - cc, valid for
// cc_lo < cc <= cc_hi); an interior tile skips it.
template <bool kMasked, int kBK>
__device__ __forceinline__ void dq_p_ds(const Args& a, const int* ksg,
                                        const int (&qpos)[2],
                                        const int (&qseg)[2],
                                        const float (&lse2)[2],
                                        const float (&dsc)[2], int k0,
                                        int offset, int t,
                                        float (&s)[kBK / 2],
                                        float (&dp)[kBK / 2]) {
  const float scale2 = a.scale * kLog2e;  // logits in log2 units
  int cc_lo[2], cc_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int d0 = qpos[r] + offset - k0 - 2 * t;
    cc_lo[r] = d0 - band_hi(a);
    cc_hi[r] = d0 - band_lo(a);
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float& x = s[4 * j + e];
      if constexpr (kMasked) {
        const int cc = 8 * j + (e & 1);
        // the stage's key ids are read whether or not there are any
        const bool ok = (cc > cc_lo[r]) & (cc <= cc_hi[r]) &
                        (!a.qseg | (qseg[r] == ksg[cc]));
        x = ex2((ok ? x * scale2 : kNegInf * kLog2e) - lse2[r]);
      } else {
        x = ex2(fmaf(x, scale2, -lse2[r]));
      }
      dp[4 * j + e] = x * fmaf(dp[4 * j + e], a.scale, -dsc[r]);
    }
  }
}

// dQ += dS.K for one k tile: dS (64 x kBK, bf16) in registers, the K tile
// `ks` MN-major in shared memory; issued, not waited for.
template <int D, int kBK = DqTile<D>::kBK>
__device__ __forceinline__ void dq_grad(float (&dq)[D / kCols][32],
                                        const uint32_t (&dsa)[kBK / 16][4],
                                        const bf16* ks) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int n = 0; n < D / kCols; ++n)
      wgmma_rs_n64(dq[n], dsa[kk], desc_mn(tile_at(ks, kBK, kk * 16, n * 64)));
}

// Persistent: one CTA per SM walks the work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ...; its producer runs ahead into the next
// item (two Q/dO buffers, the k/v ring continuing across items) while
// the consumers finish the last one.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const Args a) {
  using T = DqTile<D>;
  constexpr int kBQ = T::kBQ, kBK = T::kBK, kS = T::kStages;
  uint8_t* smem = smem_base();
  bf16* qbufs = reinterpret_cast<bf16*>(smem);            // 2 x (Q, dO)
  bf16* kv = reinterpret_cast<bf16*>(smem + T::kKVOff);  // stage: K, V
  float* rows = reinterpret_cast<float*>(smem + T::kRowOff);
  int* kseg_s = reinterpret_cast<int*>(smem + T::kSegOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kS;
  uint64_t* qfull = empty + kS;
  uint64_t* qempty = qfull + 2;

  const int items = a.Lq / kBQ * a.H * a.B;
  const int group = a.H / a.Hkv;
  const int offset = a.Lk - a.Lq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      int i = 0, n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const QItem it = q_item(a, w, kBQ);
        const int q0 = it.qb * kBQ, hk = it.h / group;
        bf16* qs = qbufs + (n & 1) * 2 * kBQ * D;
        float* rs = rows + (n & 1) * 3 * kBQ;
        if (n >= 2) mbar_wait(&qempty[n & 1], (n / 2 + 1) & 1);
        mbar_expect_tx(&qfull[n & 1], 2 * T::kQBytes + (a.qseg ? 3 : 2) *
                                                           T::kRowBytes);
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(qs + c * kBQ * kCols, &tm_q, &qfull[n & 1], c * kCols,
                   it.h, q0, it.b);
          tma_load(qs + kBQ * D + c * kBQ * kCols, &tm_do, &qfull[n & 1],
                   c * kCols, it.h, q0, it.b);
        }
        const size_t row =
            (static_cast<size_t>(it.b) * a.H + it.h) * a.Lq + q0;
        bulk_load(rs, a.lse + row, T::kRowBytes, &qfull[n & 1]);
        bulk_load(rs + kBQ, a.delta + row, T::kRowBytes, &qfull[n & 1]);
        if (a.qseg)
          bulk_load(rs + 2 * kBQ,
                    a.qseg + static_cast<size_t>(it.b) * a.Lq + q0,
                    T::kRowBytes, &qfull[n & 1]);
        for (int kb = dq_k_tile<D>(a, q0, kb_lo(a, q0, kBK, offset), offset);
             kb >= 0; kb = dq_k_tile<D>(a, q0, kb + 1, offset), ++i) {
          const int s = i % kS;
          if (i >= kS) mbar_wait(&empty[s], (i / kS + 1) & 1);
          mbar_expect_tx(&full[s], 2 * T::kKVBytes + (a.kseg ? kBK * 4 : 0));
          bf16* ks = kv + s * 2 * kBK * D;
          for (int c = 0; c < D / kCols; ++c) {
            tma_load(ks + c * kBK * kCols, &tm_k, &full[s], c * kCols, hk,
                     kb * kBK, it.b);
            tma_load(ks + kBK * D + c * kBK * kCols, &tm_v, &full[s],
                     c * kCols, hk, kb * kBK, it.b);
          }
          if (a.kseg)
            bulk_load(kseg_s + s * kBK,
                      a.kseg + static_cast<size_t>(it.b) * a.Lk + kb * kBK,
                      kBK * 4, &full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroup c owns q rows q0 + 64c .. q0 + 64c + 63 of an item
  reg_alloc<232>();
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_ld = static_cast<size_t>(a.H) * D;
  float s[kBK / 2], dp[kBK / 2];  // S then P; dP then dS: 64 rows x kBK
  uint32_t dsa[kBK / 16][4];      // dS rounded to bf16, wgmma's A layout
  float dq[D / kCols][32];

  int i = 0, n = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
    const QItem it = q_item(a, w, kBQ);
    const int q0 = it.qb * kBQ, r_lo = q0 + 64 * c;
    const int row0 = 64 * c + 16 * warp + g;  // this thread's rows in the tile
    const int qpos[2] = {q0 + row0, q0 + row0 + 8};
#pragma unroll
    for (int nb = 0; nb < D / kCols; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[nb][e] = 0.f;
    const bf16* qs = qbufs + (n & 1) * 2 * kBQ * D;
    const bf16* gs = qs + kBQ * D;
    const float* rs = rows + (n & 1) * 3 * kBQ;
    mbar_wait(&qfull[n & 1], (n / 2) & 1);
    // lse in log2 units and delta.scale of this thread's two rows
    float lse2[2], dsc[2];
    int qseg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = rs[row0 + 8 * r] * kLog2e;
      dsc[r] = rs[kBQ + row0 + 8 * r] * a.scale;
      // read whether or not there are any, as the key ids
      qseg[r] = reinterpret_cast<const int*>(rs + 2 * kBQ)[row0 + 8 * r];
    }

    for (int kb = dq_k_tile<D>(a, q0, kb_lo(a, q0, kBK, offset), offset);
         kb >= 0; kb = dq_k_tile<D>(a, q0, kb + 1, offset), ++i) {
      const int st = i % kS;
      const bf16* ks = kv + st * 2 * kBK * D;
      const bf16* vs = ks + kBK * D;
      mbar_wait(&full[st], (i / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBK>(s, desc_k(tile_at(qs, kBQ, 64 * c, kk * 16)),
                      desc_k(tile_at(ks, kBK, 0, kk * 16)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBK>(dp, desc_k(tile_at(gs, kBQ, 64 * c, kk * 16)),
                      desc_k(tile_at(vs, kBK, 0, kk * 16)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const int k0 = kb * kBK;
      const int* ksg = kseg_s + st * kBK + 2 * t;
      if (tile_interior(a, r_lo, r_lo + 63, k0, k0 + kBK - 1, offset))
        dq_p_ds<false, kBK>(a, ksg, qpos, qseg, lse2, dsc, k0, offset, t, s,
                            dp);
      else
        dq_p_ds<true, kBK>(a, ksg, qpos, qseg, lse2, dsc, k0, offset, t, s,
                           dp);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) pack_a(dsa[kk], dp, kk);
#pragma unroll
      for (int nb = 0; nb < D / kCols; ++nb) fence_regs(dq[nb]);
      wgmma_fence();
      dq_grad<D>(dq, dsa, ks);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < D / kCols; ++nb) fence_regs(dq[nb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[n & 1]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = a.out +
                   (static_cast<size_t>(it.b) * a.Lq + qpos[r]) * q_ld +
                   it.h * D + 2 * t;
#pragma unroll
      for (int nb = 0; nb < D / kCols; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + nb * kCols + 8 * j) =
              __floats2bfloat162_rn(dq[nb][4 * j + 2 * r],
                                    dq[nb][4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
static cudaError_t launch_dq(const void* q, const void* k, const void* v,
                             const void* dout, const Args& a,
                             cudaStream_t st) {
  using T = DqTile<D>;
  CUtensorMap tq, tk, tv, tg;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = make_map(&tq, q, a.B, a.Lq, a.H, D, T::kBQ)) ||
      (err = make_map(&tg, dout, a.B, a.Lq, a.H, D, T::kBQ)) ||
      (err = make_map(&tk, k, a.B, a.Lk, a.Hkv, D, T::kBK)) ||
      (err = make_map(&tv, v, a.B, a.Lk, a.Hkv, D, T::kBK)) ||
      (err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  T::kSmem)))
    return err;
  const int items = a.Lq / T::kBQ * a.H * a.B;
  flash_bwd_dq_kernel<D><<<min(items, sms), kThreads, T::kSmem, st>>>(
      tq, tk, tv, tg, a);
  return cudaGetLastError();
}

}  // namespace kft::sm90

extern "C" {

// Returns a cudaError_t: the launch's own error, 0 when it was accepted.
int kft_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* qseg, const void* kseg, void* dq, int B,
                     int H, int Hkv, int Lq, int Lk, int D, float scale,
                     int causal, int window, void* stream) {
  using namespace kft::sm90;
  Args a{};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = static_cast<bf16*>(dq);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Lq = Lq; a.Lk = Lk;
  a.scale = scale; a.causal = causal; a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch_dq<64>(q, k, v, dout, a, st));
  if (D == 128) return static_cast<int>(launch_dq<128>(q, k, v, dout, a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
