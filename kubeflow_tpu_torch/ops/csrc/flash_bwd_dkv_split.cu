// Flash-attention backward for Hopper (sm_90a): dk and dv at head_dim 256.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (kubeflow_tpu/ops/
// flash_attention.py, launched from _flash_bwd_pallas) for bf16 and f16
// at head_dim 256, where flash_bwd_dkv.cu's layout cannot hold: there
// each consumer warpgroup keeps both dK and dV of its 64 keys in
// registers, 2 x 128 a thread at D 256, past the 255 a thread may have.
//
// One CTA per (64-key tile, kv head, batch row); it walks every q head of
// its group and the 64-row q tiles that can see its keys (`_qb_lo`,
// `_block_runs`), as flash_bwd_dkv.cu, and sums dk and dv over the group
// in registers. The four products are split between the two consumer
// warpgroups, each holding one 64 x 256 f32 accumulator:
//   A: S^T = K.Q^T (SS wgmma); P^T = exp(S^T.scale - lse) with the mask
//      (`_recompute_p_ds`); P^T in f32 to shared memory for B; then
//      dV += P^T.dO (RS wgmma, P^T rounded to E as p.astype);
//   B: dP^T = V.dO^T (SS wgmma); P^T from A; dS^T = P^T * (dP^T - delta)
//      * scale; then dK += dS^T.Q (RS wgmma, dS^T rounded to E).
// B takes A's P^T in f32, so P and dS are each rounded once, before their
// product, as in flash_bwd_dkv.cu and the plain version. The hand-off is
// one f32 buffer in accumulator order (thread t of A writes, as float4s,
// what thread t of B reads: no bank conflicts) and two named barriers: A
// arrives on kPFull after writing, B syncs on it (an arrive orders the
// arriving threads' shared-memory writes before the sync's return); B
// arrives on kPEmpty after reading, A syncs on it before its next write.
//
// Shared memory: K and V (2 x 32 KB), 2 stages of Q and dO (4 x 32 KB),
// P^T (16 KB), 2 stages of the lse / delta / q segment rows (1.5 KB) and
// the barriers: 211 KB with the 1 KB alignment slack. Registers a
// consumer thread: the accumulator 128, S^T or dP^T 32, P^T or dS^T
// packed 16, under setmaxnreg 240; the producer warpgroup drops to 24.
//
// Bound: four products of L^2.D/2 MACs each per (batch, head) under the
// causal mask, against ~6.L.D bytes: tensor-core bound. Each Q and dO
// tile feeds 64 keys, so L2 serves every such tile to Lk / 64 CTAs.
#include "flash_sm90.cuh"

namespace kft::sm90 {

template <int D>
struct SplitTile {
  // KERNEL_TILES["flash_bwd_dkv_split"]
  static constexpr int kBQ = 64, kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kKBytes = kBK * D * 2;    // one of K, V
  static constexpr int kQBytes = kBQ * D * 2;    // one of Q, dO
  static constexpr int kRowBytes = kBQ * 4;      // one of lse, delta, qseg
  static constexpr int kPBytes = kBK * kBQ * 4;  // P^T in f32
  // shared memory: K | V | stages x (Q | dO) | P^T | stages x (lse |
  // delta | qseg) | barriers
  static constexpr int kStageOff = 2 * kKBytes;
  static constexpr int kPOff = kStageOff + kStages * 2 * kQBytes;
  static constexpr int kRowOff = kPOff + kPBytes;
  static constexpr int kBarOff = kRowOff + kStages * 3 * kRowBytes;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

// the named barriers of the P^T hand-off, of both consumer warpgroups
constexpr int kPFull = 1, kPEmpty = 2;

// The next (q head j of the group, q tile qb), at or after (j, qb), that
// _block_runs lets see the key tile at k0; false when none is left.
// Producer and consumers walk the same tiles through it.
template <int D>
__device__ __forceinline__ bool split_q_tile(const Args& a, int k0,
                                             int qb_lo, int offset, int& j,
                                             int& qb) {
  using T = SplitTile<D>;
  for (; j < a.H / a.Hkv; ++j, qb = qb_lo)
    for (; qb < a.Lq / T::kBQ; ++qb)
      if (block_runs(a, qb * T::kBQ, T::kBQ, k0, T::kBK, offset)) return true;
  return false;
}

// Warpgroup A: P^T = exp(S^T.scale - lse) in place in st for one q tile
// (`_recompute_p_ds`): this thread's two keys kpos against q columns
// q0 + 8jj + 2t + {0, 1}, their lse and segment ids in `rows`. kMasked
// applies the element rule of _block_mask with the -1e30 fill; an
// interior tile skips it. The arithmetic is flash_bwd_dkv.cu's.
template <bool kMasked, int kBQ>
__device__ __forceinline__ void split_p(const Args& a, const float* rows,
                                        int q0, const int (&kpos)[2],
                                        const int (&kseg)[2], int offset,
                                        int t, float (&st)[kBQ / 2]) {
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
    const float lse2[2] = {lse.x * kLog2e, lse.y * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = st[4 * jj + e];
      if constexpr (kMasked) {
        const int r = e >> 1, cc = 8 * jj + (e & 1);
        // the stage's q ids are read whether or not there are any
        const bool ok = (cc >= cc_lo[r]) & (cc < cc_hi[r]) &
                        (!a.qseg | (qseg_s[c0 + (e & 1)] == kseg[r]));
        // a masked logit cancels exactly against the lse of a q row no
        // key may attend (-1e30): exp(0) = 1, as in the plain version; the
        // fill and the lse are each rounded on their own (__fmul_rn), so
        // nvcc cannot contract them into one fma
        const float l = (e & 1) ? lse.y : lse.x;
        x = ok ? ex2(fmaf(-l, kLog2e, x * scale2))
               : ex2(kNegInf * kLog2e - __fmul_rn(l, kLog2e));
      } else {
        x = ex2(fmaf(x, scale2, -lse2[e & 1]));
      }
    }
  }
}

// Warpgroup B: dS^T = P^T * (dP^T - delta) * scale in place in dpt for
// one q tile, P^T read from A's buffer `pt` (thread `tid`'s float4s),
// delta from the stage's rows.
template <int kBQ>
__device__ __forceinline__ void split_ds(const Args& a, const float* delta_s,
                                         const float4* pt, int tid, int t,
                                         float (&dpt)[kBQ / 2]) {
#pragma unroll
  for (int jj = 0; jj < kBQ / 8; ++jj) {
    const float2 del = *reinterpret_cast<const float2*>(delta_s + 8 * jj +
                                                        2 * t);
    const float dsc[2] = {del.x * a.scale, del.y * a.scale};
    const float4 p4 = pt[jj * 128 + tid];
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * jj + e] = p[e] * fmaf(dpt[4 * jj + e], a.scale, -dsc[e & 1]);
  }
}

// One consumer warpgroup's walk over the q tiles, by role: kRole 0 is A
// (P^T, dV into a.out2), 1 is B (dS^T, dK into a.out). Each role is its
// own straight-line loop: no branch on the role inside it.
template <int kRole, int D, typename E>
__device__ __forceinline__ void split_consumer(
    const Args& a, const E* ks, const E* vs, const E* qg, float4* pt,
    const float* rows, uint64_t* full, uint64_t* empty, uint64_t* kvbar,
    int hk, int b, int k0, int qb_lo, int offset) {
  using T = SplitTile<D>;
  constexpr int kBQ = T::kBQ, kBK = T::kBK, kS = T::kStages;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kpos[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  int kseg[2] = {0, 0};
  if (kRole == 0 && a.kseg) {
    kseg[0] = a.kseg[static_cast<size_t>(b) * a.Lk + kpos[0]];
    kseg[1] = a.kseg[static_cast<size_t>(b) * a.Lk + kpos[1]];
  }
  float acc[D / kCols][32];  // A: dV; B: dK
#pragma unroll
  for (int n = 0; n < D / kCols; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  // transposed blocks: rows are the tile's keys, columns the q tile
  float st[kBQ / 2];            // A: S^T then P^T; B: dP^T then dS^T
  uint32_t pk[kBQ / 16][4];     // P^T or dS^T rounded to E
  const E* lhs = kRole == 0 ? ks : vs;

  mbar_wait(kvbar, 0);
  int j = 0, qb = qb_lo, i = 0;
  bool more = split_q_tile<D>(a, k0, qb_lo, offset, j, qb);
  while (more) {
    const int s = i % kS;
    const E* qt = qg + s * 2 * kBQ * D;
    const E* gt = qt + kBQ * D;
    const float* rs = rows + s * 3 * kBQ;
    const int q0 = qb * kBQ;
    ++qb;
    more = split_q_tile<D>(a, k0, qb_lo, offset, j, qb);
    mbar_wait(&full[s], (i / kS) & 1);
    // A: S^T = K.Q^T; B: dP^T = V.dO^T
    const E* rhs = kRole == 0 ? qt : gt;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<E>(st, desc_k(tile_at(lhs, kBK, 0, kk * 16)),
                      desc_k(tile_at(rhs, kBQ, 0, kk * 16)), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if constexpr (kRole == 0) {
      if (tile_interior(a, q0, q0 + kBQ - 1, k0, k0 + kBK - 1, offset))
        split_p<false, kBQ>(a, rs, q0, kpos, kseg, offset, t, st);
      else
        split_p<true, kBQ>(a, rs, q0, kpos, kseg, offset, t, st);
      if (i > 0) bar_sync(kPEmpty, kConsumers);  // B has read the last P^T
#pragma unroll
      for (int jj = 0; jj < kBQ / 8; ++jj)
        pt[jj * 128 + tid] = make_float4(st[4 * jj], st[4 * jj + 1],
                                         st[4 * jj + 2], st[4 * jj + 3]);
      bar_arrive(kPFull, kConsumers);
    } else {
      bar_sync(kPFull, kConsumers);
      split_ds<kBQ>(a, rs + kBQ, pt, tid, t, st);
      bar_arrive(kPEmpty, kConsumers);
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) pack_a<E>(pk[kk], st, kk);
    // A: dV += P^T.dO; B: dK += dS^T.Q, the stage's tile read MN-major
    const E* mn = kRole == 0 ? gt : qt;
#pragma unroll
    for (int n = 0; n < D / kCols; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / kCols; ++n)
        wgmma_rs_n64<E>(acc[n], pk[kk],
                        desc_mn(tile_at(mn, kBQ, kk * 16, n * 64)));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < D / kCols; ++n) fence_regs(acc[n]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    ++i;
  }
  // one sync of A for each arrival of B: the last one after the loop
  if (kRole == 0 && i > 0) bar_sync(kPEmpty, kConsumers);

  const size_t kv_ld = static_cast<size_t>(a.Hkv) * D;
  E* dst = static_cast<E*>(kRole == 0 ? a.out2 : a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off =
        (static_cast<size_t>(b) * a.Lk + kpos[r]) * kv_ld + hk * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / kCols; ++n)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        store2(dst + off + n * kCols + 8 * jj, acc[n][4 * jj + 2 * r],
               acc[n][4 * jj + 2 * r + 1]);
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const Args a) {
  using T = SplitTile<D>;
  constexpr int kBQ = T::kBQ, kBK = T::kBK, kS = T::kStages;
  uint8_t* smem = smem_base();
  E* ks = reinterpret_cast<E*>(smem);
  E* vs = ks + kBK * D;
  E* qg = reinterpret_cast<E*>(smem + T::kStageOff);  // stage: Q, dO
  float4* pt = reinterpret_cast<float4*>(smem + T::kPOff);
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
      for (int i = 0; split_q_tile<D>(a, k0, qb_lo, offset, j, qb);
           ++i, ++qb) {
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

  reg_alloc<240>();
  if (threadIdx.x < 128)
    split_consumer<0, D, E>(a, ks, vs, qg, pt, rows, full, empty, kvbar, hk,
                            b, k0, qb_lo, offset);
  else
    split_consumer<1, D, E>(a, ks, vs, qg, pt, rows, full, empty, kvbar, hk,
                            b, k0, qb_lo, offset);
}

template <int D, typename E>
static cudaError_t launch_dkv_split(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const Args& a, cudaStream_t st) {
  using T = SplitTile<D>;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err;
  if ((err = make_map<E>(&tq, q, a.B, a.Lq, a.H, D, T::kBQ)) ||
      (err = make_map<E>(&tg, dout, a.B, a.Lq, a.H, D, T::kBQ)) ||
      (err = make_map<E>(&tk, k, a.B, a.Lk, a.Hkv, D, T::kBK)) ||
      (err = make_map<E>(&tv, v, a.B, a.Lk, a.Hkv, D, T::kBK)))
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_split_kernel<D, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err) return err;
  const dim3 grid(a.Hkv, a.B, a.Lk / T::kBK);
  flash_bwd_dkv_split_kernel<D, E><<<grid, kThreads, T::kSmem, st>>>(
      tq, tk, tv, tg, a);
  return cudaGetLastError();
}

}  // namespace kft::sm90

extern "C" {

// Returns a cudaError_t: the launch's own error, 0 when it was accepted;
// cudaErrorInvalidValue for any head dim but 256.
int kft_flash_bwd_dkv_split(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* qseg,
                            const void* kseg, void* dk, void* dv, int B,
                            int H, int Hkv, int Lq, int Lk, int D, int elem,
                            float scale, int causal, int window,
                            void* stream) {
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
  if (elem == kElemBf16 && D == 256)
    return static_cast<int>(launch_dkv_split<256, bf16>(q, k, v, dout, a, st));
  if (elem == kElemF16 && D == 256)
    return static_cast<int>(launch_dkv_split<256, f16>(q, k, v, dout, a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
