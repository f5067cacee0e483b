// Flash-attention forward for Hopper (sm_90a): out and lse.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_flash_fwd`
// (kubeflow_tpu/ops/flash_attention.py). A work item is one (128-row q
// tile, q head, batch row), heaviest causal tiles first, on a persistent
// grid of one CTA per SM; it walks the k/v tiles (128 keys; 64 at head
// dim 256) the causal/window rules let it see, and keeps the online
// softmax (running max m, running sum l, output accumulator) in
// registers, as the TPU kernel keeps it in VMEM scratch across its
// sequential k grid axis.
//
// Bound: at the training shapes (L 2048, D 64) the two products are
// 4.L^2.D/2 FLOPs per (batch, head) against 4.L.D bytes of q/k/v/out,
// far above the card's ~295 FLOP/byte ridge: tensor-core bound on paper,
// with the softmax's exp as large at D 64 (one exp per 128 FLOPs of
// products: a 128 x 128 tile takes as long on the SM's 16 exp units as
// on its tensor cores). On the card the softmax's instruction stream,
// not the products, sets the time at D 64 (PERF.md). At D 256 there is
// one exp per 512 FLOPs of products: the products should set the time.
// Design: warp specialisation. One producer thread streams k/v tiles by
// TMA into a ring of shared-memory stages guarded by mbarriers; two
// consumer warpgroups of 64 q rows each run S = Q.K^T as an SS wgmma,
// the softmax in registers, and O += P.V as an RS wgmma with P rounded
// to E in registers (as the TPU kernel's p.astype(v.dtype)) and V read
// MN-major straight from the TMA tile. Only tiles the causal or window
// rule cuts, and every tile when segment ids are given, take the
// per-element mask. E, the element type of q/k/v/out, is bf16 or f16:
// wgmma and TMA take both at the same shapes.
//
// Shared memory and registers by head dim (FwdTile): at D 64 and 128,
// two Q buffers of 128 rows (the producer loads the next item's Q while
// the consumers finish this one) and 128-key K/V stages (3 at D 64, 2 at
// 128); a consumer thread holds S over 128 keys (64 registers), P packed
// (32) and O (D / 2). At D 256 that layout would pass both limits (two
// Q buffers are 128 KB, two 128-key stages 256 KB more; O alone is 128
// registers), so D 256 takes one Q buffer (64 KB), 64-key K/V stages
// (2 x 64 KB) and S over 64 keys: 193 KB of shared memory, and O 128 +
// S 32 + P 16 registers a consumer thread under setmaxnreg 232.
#include "flash_sm90.cuh"

namespace kft::sm90 {

template <int D>
struct FwdTile {
  // KERNEL_TILES["flash_fwd"]
  static constexpr int kBQ = 128, kBK = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBufs = D == 256 ? 1 : 2;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // one of K, V
  // shared memory: Q buffers | stages x (K | V) | stages x kseg | barriers
  static constexpr int kKVOff = kQBufs * kQBytes;
  static constexpr int kSegOff = kKVOff + kStages * 2 * kKVBytes;
  static constexpr int kBarOff = kSegOff + kStages * kBK * 4;
  static constexpr int kSmem =
      kBarOff + (2 * kStages + 2 * kQBufs) * 8 + 1024;
};

// The first k tile at or after kb that _block_runs lets the q tile at q0
// see, or -1. Producer and consumers walk the same tiles through it.
template <int D>
__device__ __forceinline__ int fwd_k_tile(const Args& a, int q0, int kb,
                                          int offset) {
  using T = FwdTile<D>;
  for (; kb < a.Lk / T::kBK; ++kb)
    if (block_runs(a, q0, T::kBQ, kb * T::kBK, T::kBK, offset)) return kb;
  return -1;
}

// O += P.V for one k tile: P (64 x kBK, type E) in registers, the V
// tile `vs` MN-major in shared memory; issued, not waited for.
template <int D, typename E>
__device__ __forceinline__ void fwd_pv(
    float (&o)[D / kCols][32], const uint32_t (&pa)[FwdTile<D>::kBK / 16][4],
    const E* vs) {
  constexpr int kBK = FwdTile<D>::kBK;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int n = 0; n < D / kCols; ++n)
      wgmma_rs_n64<E>(o[n], pa[kk], desc_mn(tile_at(vs, kBK, kk * 16, n * 64)));
}

// Persistent: one CTA per SM walks the work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ...; its producer runs ahead into the next
// item (the k/v ring continuing across items, and with two Q buffers the
// next Q) while the consumers finish the last one.
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using T = FwdTile<D>;
  constexpr int kBQ = T::kBQ, kBK = T::kBK, kS = T::kStages;
  constexpr int kQB = T::kQBufs;
  uint8_t* smem = smem_base();
  E* qbufs = reinterpret_cast<E*>(smem);                // kQB x Q
  E* kv = reinterpret_cast<E*>(smem + T::kKVOff);      // stage: K, V
  int* kseg_s = reinterpret_cast<int*>(smem + T::kSegOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kS;
  uint64_t* qfull = empty + kS;
  uint64_t* qempty = qfull + kQB;

  const int items = a.Lq / kBQ * a.H * a.B;
  const int group = a.H / a.Hkv;
  const int offset = a.Lk - a.Lq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kQB; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup
    // its loop over items needs 40 registers; 128 x 40 + 256 x 232 fits
    // the SM's 65,536
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      int i = 0, n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const QItem it = q_item(a, w, kBQ);
        const int q0 = it.qb * kBQ, hk = it.h / group;
        const int qi = n % kQB;
        E* qs = qbufs + qi * kBQ * D;
        if (n >= kQB) mbar_wait(&qempty[qi], (n / kQB + 1) & 1);
        mbar_expect_tx(&qfull[qi], T::kQBytes);
        for (int c = 0; c < D / kCols; ++c)
          tma_load(qs + c * kBQ * kCols, &tm_q, &qfull[qi], c * kCols,
                   it.h, q0, it.b);
        for (int kb = fwd_k_tile<D>(a, q0, kb_lo(a, q0, kBK, offset), offset);
             kb >= 0; kb = fwd_k_tile<D>(a, q0, kb + 1, offset), ++i) {
          const int s = i % kS;
          if (i >= kS) mbar_wait(&empty[s], (i / kS + 1) & 1);
          mbar_expect_tx(&full[s], 2 * T::kKVBytes + (a.kseg ? kBK * 4 : 0));
          E* ks = kv + s * 2 * kBK * D;
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
  const float scale2 = a.scale * kLog2e;  // logits in log2 units
  const float fill2 = kNegInf * kLog2e;   // the -1e30 fill, in log2 units
  const size_t q_ld = static_cast<size_t>(a.H) * D;
  float sc[kBK / 2];         // S, then P: 64 rows x kBK keys
  uint32_t pa[kBK / 16][4];  // P rounded to E, wgmma's A layout
  float o[D / kCols][32];

  int i = 0, n = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
    const QItem it = q_item(a, w, kBQ);
    const int q0 = it.qb * kBQ, r_lo = q0 + 64 * c;
    const int qpos[2] = {r_lo + 16 * warp + g, r_lo + 16 * warp + g + 8};
    int qseg[2] = {0, 0};
    if (a.qseg) {
      qseg[0] = a.qseg[static_cast<size_t>(it.b) * a.Lq + qpos[0]];
      qseg[1] = a.qseg[static_cast<size_t>(it.b) * a.Lq + qpos[1]];
    }
    // m in log2 units; l is this thread's share of the row sum (its
    // kBK / 4 columns of each tile), summed over the quad at the end
    float m[2] = {fill2, fill2}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < D / kCols; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;
    const int qi = n % kQB;
    const E* qs = qbufs + qi * kBQ * D;
    mbar_wait(&qfull[qi], (n / kQB) & 1);

    for (int kb = fwd_k_tile<D>(a, q0, kb_lo(a, q0, kBK, offset), offset);
         kb >= 0; kb = fwd_k_tile<D>(a, q0, kb + 1, offset), ++i) {
      const int s = i % kS;
      const E* ks = kv + s * 2 * kBK * D;
      mbar_wait(&full[s], (i / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBK, E>(sc, desc_k(tile_at(qs, kBQ, 64 * c, kk * 16)),
                         desc_k(tile_at(ks, kBK, 0, kk * 16)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax: sc becomes P, m and l move on, O is scaled by alpha
      float alpha[2];
      const int k0 = kb * kBK;
      if (tile_interior(a, r_lo, r_lo + 63, k0, k0 + kBK - 1, offset)) {
        // every logit valid: the max of the raw products, then one FMA
        // per logit for scale and shift
        float mc[2] = {sc[0], sc[2]};
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e)
          mc[(e >> 1) & 1] = fmaxf(mc[(e >> 1) & 1], sc[e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(mc[r]) * scale2);
          alpha[r] = ex2(m[r] - mn);
          m[r] = mn;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int r = (e >> 1) & 1;
          sc[e] = ex2(fmaf(sc[e], scale2, -m[r]));
          l[r] += sc[e];
        }
      } else {
        // key k0 + 2t + cc of row r lies at distance d0 - cc, valid for
        // cc_lo < cc <= cc_hi: two compares against a constant per logit
        const int* ksg = kseg_s + s * kBK + 2 * t;
        int cc_lo[2], cc_hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int d0 = qpos[r] + offset - k0 - 2 * t;
          cc_lo[r] = d0 - band_hi(a);
          cc_hi[r] = d0 - band_lo(a);
        }
        float mc[2] = {fill2, fill2};
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, cc = 8 * j + (e & 1);
            // the stage's key ids are read whether or not there are any
            const bool ok = (cc > cc_lo[r]) & (cc <= cc_hi[r]) &
                            (!a.qseg | (qseg[r] == ksg[cc]));
            sc[4 * j + e] = ok ? sc[4 * j + e] * scale2 : fill2;
            mc[r] = fmaxf(mc[r], sc[4 * j + e]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(mc[r]));
          alpha[r] = ex2(m[r] - mn);
          m[r] = mn;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int r = (e >> 1) & 1;
          sc[e] = ex2(sc[e] - m[r]);
          l[r] += sc[e];
        }
      }
#pragma unroll
      for (int nb = 0; nb < D / kCols; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[nb][e] *= alpha[(e >> 1) & 1];

      // O += P . V, P rounded to E
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) pack_a<E>(pa[kk], sc, kk);
#pragma unroll
      for (int nb = 0; nb < D / kCols; ++nb) fence_regs(o[nb]);
      wgmma_fence();
      fwd_pv<D>(o, pa, ks + kBK * D);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < D / kCols; ++nb) fence_regs(o[nb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[qi]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float li = fmaxf(quad_sum(l[r]), 1e-20f);
      const float inv = 1.f / li;
      E* orow = static_cast<E*>(a.out) +
                   (static_cast<size_t>(it.b) * a.Lq + qpos[r]) * q_ld +
                   it.h * D + 2 * t;
#pragma unroll
      for (int nb = 0; nb < D / kCols; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store2(orow + nb * kCols + 8 * j, o[nb][4 * j + 2 * r] * inv,
                 o[nb][4 * j + 2 * r + 1] * inv);
      if (t == 0) {
        // a row that saw only masked logits keeps the fill exactly, as the
        // plain version's m = -1e30 does
        const float mn = m[r] == fill2 ? kNegInf : m[r] * kLn2;
        a.lse_out[(static_cast<size_t>(it.b) * a.H + it.h) * a.Lq +
                  qpos[r]] = mn + logf(li);
      }
    }
  }
}

template <int D, typename E>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                              const Args& a, cudaStream_t st) {
  using T = FwdTile<D>;
  CUtensorMap tq, tk, tv;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = make_map<E>(&tq, q, a.B, a.Lq, a.H, D, T::kBQ)) ||
      (err = make_map<E>(&tk, k, a.B, a.Lk, a.Hkv, D, T::kBK)) ||
      (err = make_map<E>(&tv, v, a.B, a.Lk, a.Hkv, D, T::kBK)) ||
      (err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaFuncSetAttribute(flash_fwd_kernel<D, E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  T::kSmem)))
    return err;
  const int items = a.Lq / T::kBQ * a.H * a.B;
  flash_fwd_kernel<D, E><<<min(items, sms), kThreads, T::kSmem, st>>>(
      tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace kft::sm90

extern "C" {

const char* kft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t: the launch's own error, 0 when it was accepted.
int kft_flash_fwd(const void* q, const void* k, const void* v,
                  const void* qseg, const void* kseg, void* out, void* lse,
                  int B, int H, int Hkv, int Lq, int Lk, int D, int elem,
                  float scale, int causal, int window, void* stream) {
  using namespace kft::sm90;
  Args a{};
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Lq = Lq; a.Lk = Lk;
  a.scale = scale; a.causal = causal; a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == kElemBf16 && D == 64)
    return static_cast<int>(launch_fwd<64, bf16>(q, k, v, a, st));
  if (elem == kElemBf16 && D == 128)
    return static_cast<int>(launch_fwd<128, bf16>(q, k, v, a, st));
  if (elem == kElemF16 && D == 64)
    return static_cast<int>(launch_fwd<64, f16>(q, k, v, a, st));
  if (elem == kElemF16 && D == 128)
    return static_cast<int>(launch_fwd<128, f16>(q, k, v, a, st));
  if (elem == kElemBf16 && D == 256)
    return static_cast<int>(launch_fwd<256, bf16>(q, k, v, a, st));
  if (elem == kElemF16 && D == 256)
    return static_cast<int>(launch_fwd<256, f16>(q, k, v, a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
