// Flash-attention backward for Hopper (sm_90a): dk and dv.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (kubeflow_tpu/ops/
// flash_attention.py, launched from _flash_bwd_pallas). One CTA per
// (128-key tile, kv head, batch row); it walks every q head of its group
// and the 64-row q tiles that can see its keys, recomputes p = exp(s -
// lse) from the forward's saved lse and ds = p * (dp - delta) * scale
// (`_recompute_p_ds`, delta = rowsum(dO * O) from the caller), and sums
// dk and dv over the group in registers: grouped-query attention needs
// no repeated k/v and no second reduction pass.
//
// Bound: four products of L^2.D/2 MACs each per (batch, head) under the
// causal mask over ~6.L.D bytes: tensor-core bound, with one exp per
// 256 FLOPs of products at D 64. Design, as flash_fwd.cu: one producer
// thread streams q/dO tiles (and their lse, delta and segment rows) by
// TMA into a ring of shared-memory stages guarded by mbarriers; two
// consumer warpgroups of 64 keys each compute S^T = K.Q^T and
// dP^T = V.dO^T as SS wgmma, form P^T and dS^T in registers rounded to
// E (as the TPU kernel's p.astype / ds.astype), and accumulate
// dV += P^T.dO and dK += dS^T.Q as RS wgmma, with dO and Q read MN-major
// straight from the TMA tiles. E, the element type, is bf16 or f16.
#include "flash_sm90.cuh"

namespace kft::sm90 {

template <int D>
struct DkvTile {
  static constexpr int kBQ = 64, kBK = 128;  // KERNEL_TILES["flash_bwd_dkv"]
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kKBytes = kBK * D * 2;  // one of K, V
  static constexpr int kQBytes = kBQ * D * 2;  // one of Q, dO
  static constexpr int kRowBytes = kBQ * 4;    // one of lse, delta, qseg
  // shared memory: K | V | stages x (Q | dO) | stages x (lse | delta |
  // qseg) | barriers
  static constexpr int kStageOff = 2 * kKBytes;
  static constexpr int kRowOff = kStageOff + kStages * 2 * kQBytes;
  static constexpr int kBarOff = kRowOff + kStages * 3 * kRowBytes;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

// The next (q head j of the group, q tile qb), at or after (j, qb), that
// _block_runs lets see the key tile at k0; false when none is left.
// Producer and consumers walk the same tiles through it.
template <int D>
__device__ __forceinline__ bool dkv_q_tile(const Args& a, int k0, int qb_lo,
                                           int offset, int& j, int& qb) {
  using T = DkvTile<D>;
  for (; j < a.H / a.Hkv; ++j, qb = qb_lo)
    for (; qb < a.Lq / T::kBQ; ++qb)
      if (block_runs(a, qb * T::kBQ, T::kBQ, k0, T::kBK, offset)) return true;
  return false;
}

// dV += P^T.dO and dK += dS^T.Q for one q tile: P^T and dS^T (64 keys x
// 64 q rows, type E) in registers, the tile's Q and dO (`qg`, dO after Q)
// MN-major in shared memory; issued, not waited for.
template <int D, typename E>
__device__ __forceinline__ void dkv_grads(float (&dk)[D / kCols][32],
                                          float (&dv)[D / kCols][32],
                                          const uint32_t (&pt)[4][4],
                                          const uint32_t (&dst)[4][4],
                                          const E* qg) {
  constexpr int kBQ = DkvTile<D>::kBQ;
  const E* gt = qg + kBQ * D;
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
    for (int n = 0; n < D / kCols; ++n)
      wgmma_rs_n64<E>(dv[n], pt[kk], desc_mn(tile_at(gt, kBQ, kk * 16, n * 64)));
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
    for (int n = 0; n < D / kCols; ++n)
      wgmma_rs_n64<E>(dk[n], dst[kk], desc_mn(tile_at(qg, kBQ, kk * 16, n * 64)));
}

// P^T = exp(S^T.scale - lse) and dS^T = P^T * (dP^T - delta) * scale for
// one q tile, in place in st and dpt (`_recompute_p_ds`): this thread's
// two keys kpos against q columns q0 + 8jj + 2t + {0, 1}, their lse,
// delta and segment ids in `rows`. kMasked applies the element rule of
// _block_mask with the -1e30 fill; an interior tile skips it.
template <bool kMasked, int kBQ>
__device__ __forceinline__ void dkv_p_ds(const Args& a, const float* rows,
                                         int q0, const int (&kpos)[2],
                                         const int (&kseg)[2], int offset,
                                         int t, float (&st)[kBQ / 2],
                                         float (&dpt)[kBQ / 2]) {
  const float* delta_s = rows + kBQ;
  const int* qseg_s = reinterpret_cast<const int*>(rows + 2 * kBQ);
  const float scale2 = a.scale * kLog2e;  // logits in log2 units
  // q column q0 + 2t + cc of key row r lies at distance d0 + cc, valid
  // for cc_lo <= cc < cc_hi: two compares against a constant per logit
  int cc_lo[2], cc_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int d0 = q0 + 2 * t + offset - kpos[r];
    cc_lo[r] = band_lo(a) - d0;
    cc_hi[r] = band_hi(a) - d0;
  }
#pragma unroll
  for (int jj = 0; jj < kBQ / 8; ++jj) {
    const int c0 = 8 * jj + 2 * t;
    const float2 lse = *reinterpret_cast<const float2*>(rows + c0);
    const float2 del = *reinterpret_cast<const float2*>(delta_s + c0);
    const float lse2[2] = {lse.x * kLog2e, lse.y * kLog2e};
    const float dsc[2] = {del.x * a.scale, del.y * a.scale};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = st[4 * jj + e];
      if constexpr (kMasked) {
        const int r = e >> 1, cc = 8 * jj + (e & 1);
        // the stage's q ids are read whether or not there are any
        const bool ok = (cc >= cc_lo[r]) & (cc < cc_hi[r]) &
                        (!a.qseg | (qseg_s[c0 + (e & 1)] == kseg[r]));
        // a masked logit cancels exactly against the lse of a q row no
        // key may attend (-1e30): exp(0) = 1, as in the plain version and
        // on the TPU. The fill and the lse are each rounded on their own
        // (__fmul_rn): nvcc contracted `fill - lse * log2e` into one fma,
        // whose unrounded product left such rows at p = 0. A valid logit
        // keeps that fma, as the kernel computed it before
        const float l = (e & 1) ? lse.y : lse.x;
        x = ok ? ex2(fmaf(-l, kLog2e, x * scale2))
               : ex2(kNegInf * kLog2e - __fmul_rn(l, kLog2e));
      } else {
        x = ex2(fmaf(x, scale2, -lse2[e & 1]));
      }
      dpt[4 * jj + e] = x * fmaf(dpt[4 * jj + e], a.scale, -dsc[e & 1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&dk)[D / kCols][32],
                                          float (&dv)[D / kCols][32]) {
#pragma unroll
  for (int n = 0; n < D / kCols; ++n) {
    fence_regs(dk[n]);
    fence_regs(dv[n]);
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const Args a) {
  using T = DkvTile<D>;
  constexpr int kBQ = T::kBQ, kBK = T::kBK, kS = T::kStages;
  uint8_t* smem = smem_base();
  E* ks = reinterpret_cast<E*>(smem);
  E* vs = ks + kBK * D;
  E* qg = reinterpret_cast<E*>(smem + T::kStageOff);  // stage: Q, dO
  float* rows = reinterpret_cast<float*>(smem + T::kRowOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kS;
  uint64_t* kvbar = empty + kS;

  const int hk = blockIdx.x, b = blockIdx.y, kb = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int offset = a.Lk - a.Lq;
  const int k0 = kb * kBK;
  // _qb_lo: under the causal mask no q tile before this one sees k0
  const int qb_lo = a.causal ? max(0, floor_div(k0 - offset, kBQ)) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup
    reg_dealloc<24>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kvbar, 2 * T::kKBytes);
      for (int c = 0; c < D / kCols; ++c) {
        tma_load(ks + c * kBK * kCols, &tm_k, kvbar, c * kCols, hk, k0, b);
        tma_load(vs + c * kBK * kCols, &tm_v, kvbar, c * kCols, hk, k0, b);
      }
      int j = 0, qb = qb_lo;
      for (int i = 0; dkv_q_tile<D>(a, k0, qb_lo, offset, j, qb); ++i, ++qb) {
        const int s = i % kS, h = hk * group + j;
        if (i >= kS) mbar_wait(&empty[s], (i / kS + 1) & 1);
        mbar_expect_tx(&full[s], 2 * T::kQBytes + (a.qseg ? 3 : 2) *
                                                      T::kRowBytes);
        E* qt = qg + s * 2 * kBQ * D;
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(qt + c * kBQ * kCols, &tm_q, &full[s], c * kCols, h,
                   qb * kBQ, b);
          tma_load(qt + kBQ * D + c * kBQ * kCols, &tm_do, &full[s],
                   c * kCols, h, qb * kBQ, b);
        }
        const size_t row = (static_cast<size_t>(b) * a.H + h) * a.Lq + qb * kBQ;
        float* rs = rows + s * 3 * kBQ;
        bulk_load(rs, a.lse + row, T::kRowBytes, &full[s]);
        bulk_load(rs + kBQ, a.delta + row, T::kRowBytes, &full[s]);
        if (a.qseg)
          bulk_load(rs + 2 * kBQ,
                    a.qseg + static_cast<size_t>(b) * a.Lq + qb * kBQ,
                    T::kRowBytes, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup c owns keys k0 + 64c .. k0 + 64c + 63
  reg_alloc<240>();  // dk and dv at head_dim 128 need above 200
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kc = k0 + 64 * c;
  const int kpos[2] = {kc + 16 * warp + g, kc + 16 * warp + g + 8};
  int kseg[2] = {0, 0};
  if (a.kseg) {
    kseg[0] = a.kseg[static_cast<size_t>(b) * a.Lk + kpos[0]];
    kseg[1] = a.kseg[static_cast<size_t>(b) * a.Lk + kpos[1]];
  }
  float dk[D / kCols][32], dv[D / kCols][32];
#pragma unroll
  for (int n = 0; n < D / kCols; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[n][e] = dv[n][e] = 0.f;
  // transposed blocks: rows are this warpgroup's keys, columns the q tile
  float st[kBQ / 2], dpt[kBQ / 2];           // S^T then P^T; dP^T then dS^T
  uint32_t pt[kBQ / 16][4], dst[kBQ / 16][4];  // P^T, dS^T rounded to E

  mbar_wait(kvbar, 0);
  int j = 0, qb = qb_lo, i = 0;
  bool more = dkv_q_tile<D>(a, k0, qb_lo, offset, j, qb);
  while (more) {
    const int s = i % kS;
    const E* qt = qg + s * 2 * kBQ * D;
    const E* gt = qt + kBQ * D;
    const int q0 = qb * kBQ;
    ++qb;
    more = dkv_q_tile<D>(a, k0, qb_lo, offset, j, qb);
    mbar_wait(&full[s], (i / kS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<E>(st, desc_k(tile_at(ks, kBK, 64 * c, kk * 16)),
                   desc_k(tile_at(qt, kBQ, 0, kk * 16)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<E>(dpt, desc_k(tile_at(vs, kBK, 64 * c, kk * 16)),
                   desc_k(tile_at(gt, kBQ, 0, kk * 16)), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    if (tile_interior(a, q0, q0 + kBQ - 1, kc, kc + 63, offset))
      dkv_p_ds<false, kBQ>(a, rows + s * 3 * kBQ, q0, kpos, kseg, offset, t,
                           st, dpt);
    else
      dkv_p_ds<true, kBQ>(a, rows + s * 3 * kBQ, q0, kpos, kseg, offset, t,
                          st, dpt);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      pack_a<E>(pt[kk], st, kk);
      pack_a<E>(dst[kk], dpt, kk);
    }
    fence_acc<D>(dk, dv);
    wgmma_fence();
    dkv_grads<D>(dk, dv, pt, dst, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<D>(dk, dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    ++i;
  }

  const size_t kv_ld = static_cast<size_t>(a.Hkv) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off =
        (static_cast<size_t>(b) * a.Lk + kpos[r]) * kv_ld + hk * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / kCols; ++n)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const size_t at = off + n * kCols + 8 * jj;
        store2(static_cast<E*>(a.out) + at, dk[n][4 * jj + 2 * r],
               dk[n][4 * jj + 2 * r + 1]);
        store2(static_cast<E*>(a.out2) + at, dv[n][4 * jj + 2 * r],
               dv[n][4 * jj + 2 * r + 1]);
      }
  }
}

template <int D, typename E>
static cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const Args& a,
                              cudaStream_t st) {
  using T = DkvTile<D>;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err;
  if ((err = make_map<E>(&tq, q, a.B, a.Lq, a.H, D, T::kBQ)) ||
      (err = make_map<E>(&tg, dout, a.B, a.Lq, a.H, D, T::kBQ)) ||
      (err = make_map<E>(&tk, k, a.B, a.Lk, a.Hkv, D, T::kBK)) ||
      (err = make_map<E>(&tv, v, a.B, a.Lk, a.Hkv, D, T::kBK)))
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err) return err;
  const dim3 grid(a.Hkv, a.B, a.Lk / T::kBK);
  flash_bwd_dkv_kernel<D, E><<<grid, kThreads, T::kSmem, st>>>(tq, tk, tv,
                                                                tg, a);
  return cudaGetLastError();
}

}  // namespace kft::sm90

extern "C" {

// Returns a cudaError_t: the launch's own error, 0 when it was accepted.
int kft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* qseg, const void* kseg, void* dk, void* dv,
                      int B, int H, int Hkv, int Lq, int Lk, int D, int elem,
                      float scale, int causal, int window, void* stream) {
  using namespace kft::sm90;
  Args a{};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = dk;
  a.out2 = dv;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Lq = Lq; a.Lk = Lk;
  a.scale = scale; a.causal = causal; a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == kElemBf16 && D == 64)
    return static_cast<int>(launch_dkv<64, bf16>(q, k, v, dout, a, st));
  if (elem == kElemBf16 && D == 128)
    return static_cast<int>(launch_dkv<128, bf16>(q, k, v, dout, a, st));
  if (elem == kElemF16 && D == 64)
    return static_cast<int>(launch_dkv<64, f16>(q, k, v, dout, a, st));
  if (elem == kElemF16 && D == 128)
    return static_cast<int>(launch_dkv<128, f16>(q, k, v, dout, a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
