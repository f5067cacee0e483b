// Flash attention in f32, in SIMT code: a forward (out and lse), a dq
// and a dk/dv kernel at head_dim 64, 128 and 256, each templated on
// (head_dim D, element type E); E is f32.
//
// Replaces, for f32, the Pallas TPU kernels `_fwd_kernel`,
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (kubeflow_tpu/ops/
// flash_attention.py), which take any dtype at head_dim 64, 128 or 256;
// the wgmma kernels take the 2-byte types (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_dkv.cu, and at 256 flash_bwd_dkv_split.cu for dk/dv). Every
// product here is an f32 FMA on the CUDA cores: f32 stays f32, as in the
// reference's kernel (a TF32 tensor-core product would round the
// operands to 10 bits and compute another function).
//
// Bound: the products (2 L^2 D FLOPs per (batch, head) for the forward
// under a causal mask, 3 and 4 times that for dq and dk/dv) over the
// f32 FMA rate, far above the bytes of q/k/v/out: operations bound.
// All three are register-blocked as an f32 GEMM on the CUDA cores is,
// on 64 x 64 tiles, one CTA of 256 threads each: a thread holds a 4 x 4
// block of S and every shared-memory operand load is one float4 that
// feeds 16 FMAs; the operands that change along the walk stream by
// cp.async through a ring of 64 x 64 chunks while the one before is
// computed (see each section). The skip and mask rules are the TPU
// kernels' (_block_runs, _kb_lo, _qb_lo; end-aligned causal offset Lk -
// Lq, window, segment ids, the -1e30 fill), so a row no key may attend
// averages the keys of the tiles that ran, as there.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kft::simple {

constexpr int kThreads = 256;  // 16 rows x 16 columns of threads
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;
// the launchers' element code of f32 (ELEM in ops/flash_attention.py)
constexpr int kElemF32 = 2;

template <typename E>
__device__ __forceinline__ float to_f(E x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}

struct Args {
  const void *q, *k, *v, *dout;  // [B, Lq, H, D], [B, Lk, Hkv, D] x 2, dout as q
  const float* lse;              // backward: the forward's row logsumexp
  const float* delta;            // backward: rowsum(dO * O)
  const int* qseg;               // optional [B, Lq]
  const int* kseg;               // optional [B, Lk]
  void* out;                     // forward: out; dq: dq; dk/dv: dk
  void* out2;                    // dk/dv: dv
  float* lse_out;                // forward: lse [B, H, Lq]
  int B, H, Hkv, Lq, Lk;
  float scale;
  int causal, window;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// _block_runs: can the tile of q rows [q_lo, q_lo + bq) and keys
// [k_lo, k_lo + bk) hold any valid logit?
__device__ __forceinline__ bool block_runs(const Args& a, int q_lo, int bq,
                                           int k_lo, int bk, int offset) {
  bool run = true;
  if (a.causal) run = k_lo <= q_lo + (bq - 1) + offset;
  if (a.window > 0) run = run && (q_lo + offset) - (k_lo + bk - 1) < a.window;
  return run;
}

// _block_mask: may row qpos (segment qs) attend key kpos (segment ks)?
__device__ __forceinline__ bool valid(const Args& a, int qpos, int kpos,
                                      int offset, int qs, int ks) {
  const int d = qpos + offset - kpos;
  return (!a.causal || d >= 0) && (a.window <= 0 || d < a.window) &&
         (!a.qseg || qs == ks);
}

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------
//
// Register-blocked, as an f32 GEMM on the CUDA cores is. Thread (ty, tx)
// holds S for q rows 4ty .. 4ty + 3 against keys tx + 16j (j < 4) of a
// 64-key tile, and O for the same rows at columns 64n + 4tx .. 64n + 4tx
// + 3 (n < D / 64). Every shared-memory operand load is one float4 that
// feeds 16 FMAs: Q is stored transposed (Q^T, d-major), so the thread's
// four rows at one d are one float4; a K row at four consecutive d is
// one float4; P is stored key-major (P^T), so its four rows at one key
// are one float4; a V row at the thread's four columns is one float4. A
// warp is 4 row groups x 8 key groups, so each such load reads at most
// 128 distinct bytes, one shared-memory wavefront: at the FMA rate,
// shared memory is half busy. K and V stream by cp.async through a ring of
// shared-memory stages of one 64-key x 64-column chunk each (the tile's
// K chunks for S, then its V chunks for P.V), the next chunks in flight
// while one is computed: at D 256 a whole 64-key tile of K and V beside
// Q^T would not fit shared memory twice. A row's 16 threads span two
// warps, so its running max meets in shared memory once a tile.

template <int D>
struct FwdTile {
  // KERNEL_TILES["flash_simple_fwd"]
  static constexpr int kBQ = 64, kBK = 64;
  static constexpr int kDC = 64;           // columns of a K or V chunk
  static constexpr int kChunks = D / kDC;  // K chunks of a tile (as many V)
  static constexpr int kStages = D == 256 ? 4 : 2;
  // floats a row of Q^T, of a chunk and of P^T: float4-aligned, and 4
  // banks apart, so 8 lanes reading 8 rows at one column hit 32 banks
  static constexpr int kLd = 68;
  static constexpr int kStage = kBK * kLd;
  // shared memory, in floats: Q^T [D][kLd] | stages x [kBK][kLd] | P^T
  // [kBK][kLd] | each warp column's row max (then sum) [2][kBQ]
  static constexpr int kStageOff = D * kLd;
  static constexpr int kPOff = kStageOff + kStages * kStage;
  static constexpr int kRedOff = kPOff + kBK * kLd;
  static constexpr int kSmem = (kRedOff + 2 * kBQ) * 4;
  // CTAs an SM holds: two at D 64 (69 KB) and 128 (86 KB), one at 256
  // (154 KB); two at 64 and 128 cap a thread at 128 registers
  static constexpr int kMinBlocks = D == 256 ? 1 : 2;
};

// The first k tile at or after kb that _block_runs lets the forward's q
// tile at q0 see, or -1. The stream of chunks and the consumers walk the
// same tiles through it.
template <int D>
__device__ __forceinline__ int fwd_k_tile(const Args& a, int q0, int kb,
                                          int offset) {
  using T = FwdTile<D>;
  for (; kb < a.Lk / T::kBK; ++kb)
    if (block_runs(a, q0, T::kBQ, kb * T::kBK, T::kBK, offset)) return kb;
  return -1;
}

// 16 bytes from global to shared memory, asynchronously (cp.async; both
// ends 16-byte aligned), in the current commit group.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 2^x on the special-function unit (the softmax works in log2 units).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One CTA per (64-row q tile, q head, batch row), the heaviest causal q
// tiles first (a 1-D grid, q tile slowest). Only f32: cp.async copies the
// operands as they are.
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, FwdTile<D>::kMinBlocks)
    flash_simple_fwd_kernel(const Args a) {
  static_assert(std::is_same_v<E, float>, "the SIMT forward takes f32");
  using T = FwdTile<D>;
  constexpr int kBQ = T::kBQ, kBK = T::kBK, kLd = T::kLd, kDC = T::kDC;
  constexpr int kC = T::kChunks, kS = T::kStages;
  extern __shared__ __align__(16) float fwd_shared[];
  float* qt = fwd_shared;                    // Q^T [D][kLd]
  float* ring = fwd_shared + T::kStageOff;   // kS x [kBK][kLd]: K, V chunks
  float* pt = fwd_shared + T::kPOff;         // P^T [kBK][kLd]
  float* red = fwd_shared + T::kRedOff;      // [2][kBQ]
  const int hb = a.H * a.B, w = blockIdx.x;
  const int q0 = (a.Lq / kBQ - 1 - w / hb) * kBQ;
  const int h = w % a.H, b = w % hb / a.H;
  const int hk = h / (a.H / a.Hkv), offset = a.Lk - a.Lq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = warp / 2 * 4 + lane / 8, tx = warp % 2 * 8 + lane % 8;
  const float scale2 = a.scale * kLog2e;  // logits in log2 units
  const float fill2 = kNegInf * kLog2e;   // the -1e30 fill, in log2 units

  // Q^T: lanes take consecutive rows, so the transposed stores hit
  // consecutive banks
  const E* qg = static_cast<const E*>(a.q) +
                ((static_cast<size_t>(b) * a.Lq + q0) * a.H + h) * D;
  for (int i = threadIdx.x; i < kBQ * D / 4; i += kThreads) {
    const int r = i % kBQ, c = i / kBQ * 4;
    const float4 x = ld4(qg + static_cast<size_t>(r) * a.H * D + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) qt[(c + e) * kLd + r] = to_f<E>(at(x, e));
  }

  // the stream of chunks: tile pkb's K chunks 0 .. kC - 1, then its V
  // chunks, tile after tile; `fetch` starts the next one into stage
  // pslot (nothing past the last tile) and closes one commit group
  const size_t k_ld = static_cast<size_t>(a.Hkv) * D;  // floats a key
  const E* kg = static_cast<const E*>(a.k) +
                (static_cast<size_t>(b) * a.Lk * a.Hkv + hk) * D;
  const E* vg = static_cast<const E*>(a.v) +
                (static_cast<size_t>(b) * a.Lk * a.Hkv + hk) * D;
  // _kb_lo: no k tile left of the window's reach runs
  const int lo = (a.causal && a.window > 0)
                     ? max(0, floor_div(q0 + offset - (a.window - 1), kBK))
                     : 0;
  const int kb_first = fwd_k_tile<D>(a, q0, lo, offset);
  int pkb = kb_first, pj = 0, pslot = 0;
  auto fetch = [&]() {
    if (pkb >= 0) {
      const E* src = (pj < kC ? kg : vg) +
                     static_cast<size_t>(pkb) * kBK * k_ld + pj % kC * kDC;
      float* dst = ring + pslot * T::kStage;
#pragma unroll
      for (int i = 0; i < kBK * kDC / 4 / kThreads; ++i) {
        const int f = threadIdx.x + i * kThreads;
        const int r = f / (kDC / 4), c = f % (kDC / 4) * 4;
        cp_async16(dst + r * kLd + c, src + r * k_ld + c);
      }
      if (++pj == 2 * kC) {
        pj = 0;
        pkb = fwd_k_tile<D>(a, q0, pkb + 1, offset);
      }
    }
    cp_async_commit();
    pslot = pslot + 1 == kS ? 0 : pslot + 1;
  };
  // one step of the stream: wait for its chunk (and every thread's
  // stores), then refill the stage the last step read, kS - 1 ahead
  int slot = 0;
  auto step = [&]() -> const float* {
    cp_async_wait<kS - 2>();
    __syncthreads();
    fetch();
    const float* st = ring + slot * T::kStage;
    slot = slot + 1 == kS ? 0 : slot + 1;
    return st;
  };
  for (int s = 0; s < kS - 1; ++s) fetch();

  int qsg[4];
  float m[4], l[4], o[4][kC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qsg[i] = a.qseg ? a.qseg[static_cast<size_t>(b) * a.Lq + q0 + 4 * ty + i]
                    : 0;
    m[i] = fill2;
    l[i] = 0.f;  // this thread's share of the row sum, summed at the end
#pragma unroll
    for (int n = 0; n < kC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  }

  for (int kb = kb_first; kb >= 0; kb = fwd_k_tile<D>(a, q0, kb + 1, offset)) {
    const int k0 = kb * kBK;
    // S = Q.K^T over the tile's K chunks
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < kC; ++c) {
      const float* ks = step();
#pragma unroll 4
      for (int dd = 0; dd < kDC; dd += 4) {
        float4 kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ld4(ks + (tx + 16 * j) * kLd + dd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 qv = ld4(qt + (c * kDC + dd + e) * kLd + 4 * ty);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s[i][j] = fmaf(at(qv, i), at(kv[j], e), s[i][j]);
        }
      }
    }

    // online softmax: s becomes P, m and l move on, O is scaled by alpha.
    // A tile no pair of which is masked skips the per-element rule.
    const bool interior =
        !a.qseg && (!a.causal || k0 + kBK - 1 <= q0 + offset) &&
        (a.window <= 0 || q0 + kBQ - 1 + offset - k0 < a.window);
    float mx[4];
    if (interior) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i] = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])) *
                scale2;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mx[i] = fill2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool ok = valid(
              a, q0 + 4 * ty + i, kpos, offset, qsg[i],
              a.kseg ? __ldg(a.kseg + static_cast<size_t>(b) * a.Lk + kpos)
                     : 0);
          s[i][j] = ok ? s[i][j] * scale2 : fill2;
          mx[i] = fmaxf(mx[i], s[i][j]);
        }
      }
    }
    // the row max over its 16 threads: the 8 lanes of this warp, then the
    // other warp's through shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int x = 1; x < 8; x <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], x));
      if (lane % 8 == 0) red[warp % 2 * kBQ + 4 * ty + i] = mx[i];
    }
    __syncthreads();
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn =
          fmaxf(m[i], fmaxf(red[4 * ty + i], red[kBQ + 4 * ty + i]));
      alpha[i] = ex2(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = interior ? ex2(fmaf(s[i][j], scale2, -mn))
                           : ex2(s[i][j] - mn);
        l[i] += s[i][j];
      }
#pragma unroll
      for (int n = 0; n < kC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    // O += P . V over the tile's V chunks, chunk n for columns 64n ..
#pragma unroll
    for (int n = 0; n < kC; ++n) {
      const float* vs = step();
#pragma unroll 16
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 pv = ld4(pt + kk * kLd + 4 * ty);
        const float4 vv = ld4(vs + kk * kLd + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][n][e] = fmaf(at(pv, i), at(vv, e), o[i][n][e]);
      }
    }
  }
  cp_async_wait<0>();  // the stream's empty tail groups

  // the row sum over its 16 threads, as the max
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int x = 1; x < 8; x <<= 1) l[i] += __shfl_xor_sync(kFull, l[i], x);
  }
  __syncthreads();  // every thread is past the last tile's row max
  if (lane % 8 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp % 2 * kBQ + 4 * ty + i] = l[i];
  }
  __syncthreads();
  E* out = static_cast<E*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    const float li =
        fmaxf(red[4 * ty + i] + red[kBQ + 4 * ty + i], 1e-20f);
    E* orow = out + ((static_cast<size_t>(b) * a.Lq + qpos) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < kC; ++n)
      *reinterpret_cast<float4*>(orow + 64 * n + 4 * tx) =
          make_float4(o[i][n][0] / li, o[i][n][1] / li, o[i][n][2] / li,
                      o[i][n][3] / li);
    if (tx == 0)
      // a row that saw only masked logits keeps the fill exactly, as the
      // plain version's m = -1e30 does
      a.lse_out[(static_cast<size_t>(b) * a.H + h) * a.Lq + qpos] =
          (m[i] == fill2 ? kNegInf : m[i] * kLn2) + logf(li);
  }
}

// ---------------------------------------------------------------------------
// backward: dq and dk/dv
// ---------------------------------------------------------------------------
//
// Register-blocked as the forward, on 64 x 64 tiles at every head dim.
// Each recomputes P = exp(S.scale - lse) and dS = P * (dP - delta) *
// scale (`_recompute_p_ds`) for a tile before its gradient products. dq:
// one CTA per (64-row q tile, q head, batch row) keeps Q^T and dO^T
// (d-major) in shared memory and streams, for each k tile, V's chunks (dP
// = dO.V^T), K's chunks (S = Q.K^T), then K's chunks again (dQ += dS.K;
// the last one is still in its stage). dk/dv: one CTA per (64-key tile,
// kv head, batch row) keeps K^T and V^T and streams, for each q tile of
// every q head of its GQA group, Q's chunks (S^T = K.Q^T), dO's (dP^T =
// V.dO^T), Q's again (dK += dS^T.Q) and dO's again (dV += P^T.dO, the
// last one first, still in its stage), and sums the group in registers:
// two deterministic kernels, no atomics. A thread holds 4 x 4 of S and
// of dP (rows 4ty .. 4ty + 3, keys tx + 16j; in dk/dv keys 4ty .., q rows
// tx + 16j) and its 4 rows of the gradient at columns 64n + 4tx .. 64n +
// 4tx + 3 (n < D / 64); every shared-memory operand load is one float4
// whose 4 values each feed 4 FMAs, as in the forward. dS (dq), and P and
// dS (dk/dv), pass through shared memory laid out so that the second
// product reads 4 of its rows at one key (or q row) as one float4. At D
// 256 the two stationary tiles take 136 KB: a whole K (or Q and dO) tile
// beside them would pass the 227 KB a CTA may hold, so its chunks stream
// twice from L2 instead, and the tiles stay 64 rows wide.

constexpr int kBT = 64;              // q rows and keys of a backward tile
constexpr int kBLd = 68;             // floats a row of a tile or a chunk
constexpr int kBStage = kBT * kBLd;  // floats of a 64 x 64 chunk

template <int D>
struct DqTile {
  static constexpr int kChunks = D / 64;
  static constexpr int kStages = D == 64 ? 2 : 4;
  // shared memory, in floats: Q^T [D][kBLd] | dO^T [D][kBLd] | stages x
  // [kBT][kBLd] | dS^T [kBT][kBLd] | the q tile's lse (log2 units), delta
  // and segment ids [3][kBT] (read once a k tile: held in registers they
  // spilled at D 64, under two CTAs' 128 registers a thread)
  static constexpr int kStageOff = 2 * D * kBLd;
  static constexpr int kDsOff = kStageOff + kStages * kBStage;
  static constexpr int kRowOff = kDsOff + kBT * kBLd;
  static constexpr int kSmem = (kRowOff + 3 * kBT) * 4;
  // CTAs an SM holds: two at D 64 (88 KB), one at 128 (157 KB) and 256
  // (227 KB); two cap a thread at 128 registers
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
};

template <int D>
struct DkvTile {
  static constexpr int kChunks = D / 64;
  static constexpr int kStages = D == 64 ? 2 : D == 128 ? 4 : 3;
  // shared memory, in floats: K^T [D][kBLd] | V^T [D][kBLd] | stages x
  // [kBT][kBLd] | P, q-major [kBT][kBLd] | dS, q-major [kBT][kBLd] | the q
  // tile's lse (log2 units), delta and segment ids [3][kBT] | the k tile's
  // segment ids [kBT]
  static constexpr int kStageOff = 2 * D * kBLd;
  static constexpr int kPOff = kStageOff + kStages * kBStage;
  static constexpr int kDsOff = kPOff + kBT * kBLd;
  static constexpr int kRowOff = kDsOff + kBT * kBLd;
  static constexpr int kSmem = (kRowOff + 4 * kBT) * 4;
  // two CTAs an SM at D 64 (105 KB), one at 128 (175 KB) and 256 (227 KB)
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  // P computed before dP^T, so that S^T and dP^T are not both held: it
  // keeps D 256 (dK and dV 128 registers a thread) from spilling; at D 64
  // (two CTAs' 128 registers a thread) the other order spills nothing.
  // P before dP^T reads the q tile's row values after S^T's second step.
  static constexpr bool kEarlyP = D != 64;
  static_assert(!kEarlyP || kChunks > 1, "kEarlyP needs two chunks");
};

// A ring of S shared-memory stages of one 64 x 64 chunk each, which
// cp.async fills S - 1 chunks ahead of the consumer. The producer calls
// `fetch` (or `skip`, past the end of its stream) once per chunk, the
// consumer `next` once per chunk; a chunk `next` handed out stays in its
// stage until the following `next`.
template <int S>
struct Ring {
  float* base;
  int slot = 0, pslot = 0;

  // the chunk of 64 rows `ld` floats apart and 64 columns at `src` into
  // the producer's stage, as one commit group
  __device__ __forceinline__ void fetch(const float* src, size_t ld) {
    float* dst = base + pslot * kBStage;
#pragma unroll
    for (int i = 0; i < kBT * 64 / 4 / kThreads; ++i) {
      const int f = threadIdx.x + i * kThreads;
      const int r = f / 16, c = f % 16 * 4;
      cp_async16(dst + r * kBLd + c, src + r * ld + c);
    }
    skip();
  }
  __device__ __forceinline__ void skip() {
    cp_async_commit();
    pslot = pslot + 1 == S ? 0 : pslot + 1;
  }
  // the next chunk, once it has landed and every thread is past the one
  // before (whose stage the producer refills from here on)
  __device__ __forceinline__ const float* next() {
    cp_async_wait<S - 2>();
    __syncthreads();
    const float* st = base + slot * kBStage;
    slot = slot + 1 == S ? 0 : slot + 1;
    return st;
  }
};

// Rows [r0, r0 + 64) of head h, batch row b, of a [B, L, heads, D] tensor
// into `t` transposed (d-major, rows kBLd floats apart); lanes take
// consecutive rows, so the transposed stores hit consecutive banks.
template <int D, typename E>
__device__ __forceinline__ void load_transposed(float* t, const void* x, int b,
                                                int L, int heads, int h,
                                                int r0) {
  const E* g = static_cast<const E*>(x) +
               ((static_cast<size_t>(b) * L + r0) * heads + h) * D;
  for (int i = threadIdx.x; i < kBT * D / 4; i += kThreads) {
    const int r = i % kBT, c = i / kBT * 4;
    const float4 v = ld4(g + static_cast<size_t>(r) * heads * D + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) t[(c + e) * kBLd + r] = to_f<E>(at(v, e));
  }
}

// acc[i][j] += sum over the 64 columns x of one chunk of ta[x][4ty + i] *
// rows[tx + 16j][x]: `ta` d-major (4 of acc's rows at one column are one
// float4), `rows` a streamed chunk. Per 4 columns, 8 float4 loads feed
// 64 FMAs.
__device__ __forceinline__ void chunk_product(float (&acc)[4][4],
                                              const float* ta,
                                              const float* rows, int ty,
                                              int tx) {
#pragma unroll 4
  for (int x = 0; x < 64; x += 4) {
    float4 rv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) rv[j] = ld4(rows + (tx + 16 * j) * kBLd + x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 av = ld4(ta + (x + e) * kBLd + 4 * ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(at(av, i), at(rv[j], e), acc[i][j]);
    }
  }
}

// acc[i][e] += sum over the 64 rows y of xt[y][4ty + i] * chunk[y][4tx +
// e]: `xt` holds 4 of acc's rows at one y as one float4 (dS^T in dq; P
// and dS, q-major, in dk/dv), `chunk` a streamed chunk. 2 float4 loads
// feed 16 FMAs.
__device__ __forceinline__ void rows_product(float (&acc)[4][4],
                                             const float* xt,
                                             const float* chunk, int ty,
                                             int tx) {
#pragma unroll 16
  for (int y = 0; y < kBT; ++y) {
    const float4 xv = ld4(xt + y * kBLd + 4 * ty);
    const float4 cv = ld4(chunk + y * kBLd + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][e] = fmaf(at(xv, i), at(cv, e), acc[i][e]);
  }
}

// Thread t < 192's value of the q rows [q0, q0 + 64) of head h, batch row
// b: row t % 64's lse (t < 64), delta (t < 128) or segment id (its bits
// as a float); 0 for the other threads.
__device__ __forceinline__ float q_row_value(const Args& a, int b, int h,
                                             int q0) {
  const int t = threadIdx.x, r = t % kBT;
  const size_t row = (static_cast<size_t>(b) * a.H + h) * a.Lq + q0 + r;
  if (t < kBT) return a.lse[row];
  if (t < 2 * kBT) return a.delta[row];
  if (t < 3 * kBT && a.qseg)
    return __int_as_float(a.qseg[static_cast<size_t>(b) * a.Lq + q0 + r]);
  return 0.f;
}

// q_row_value into rows [3][64] (lse, delta, segment ids), the lse in log2
// units and rounded on its own, so that a row no key may attend (lse the
// fill) gets fill2 - lse2 = 0 exactly: p = 1.
__device__ __forceinline__ void store_q_rows(float* rows, float v) {
  if (threadIdx.x < 3 * kBT)
    rows[threadIdx.x] = threadIdx.x < kBT ? __fmul_rn(v, kLog2e) : v;
}

// No pair of the tile (q rows [q0, q0 + 64), keys [k0, k0 + 64)) is
// masked, so P takes no per-element rule.
__device__ __forceinline__ bool bwd_interior(const Args& a, int q0, int k0,
                                             int offset) {
  return !a.qseg && (!a.causal || k0 + kBT - 1 <= q0 + offset) &&
         (a.window <= 0 || q0 + kBT - 1 + offset - k0 < a.window);
}

// The first q tile at or after qb that _block_runs lets see the k tile at
// k0, or -1 (dk/dv's walk; dq walks the k tiles as the forward does,
// fwd_k_tile).
__device__ __forceinline__ int bwd_q_tile(const Args& a, int k0, int qb,
                                          int offset) {
  for (; qb < a.Lq / kBT; ++qb)
    if (block_runs(a, qb * kBT, kBT, k0, kBT, offset)) return qb;
  return -1;
}

// dq: one CTA per (64-row q tile, q head, batch row), the heaviest causal
// q tiles first (a 1-D grid, q tile slowest), as the forward.
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, DqTile<D>::kMinBlocks)
    flash_simple_bwd_dq_kernel(const Args a) {
  static_assert(std::is_same_v<E, float>, "the SIMT backward takes f32");
  static_assert(FwdTile<D>::kBQ == kBT && FwdTile<D>::kBK == kBT,
                "dq walks its k tiles with fwd_k_tile");
  using T = DqTile<D>;
  constexpr int kC = T::kChunks, kS = T::kStages;
  extern __shared__ __align__(16) float dq_shared[];
  float* qt = dq_shared;                 // Q^T [D][kBLd]
  float* gt = dq_shared + D * kBLd;      // dO^T [D][kBLd]
  float* dst = dq_shared + T::kDsOff;    // dS^T [kBT][kBLd]
  float* rows = dq_shared + T::kRowOff;  // lse2, delta, q segment ids
  Ring<kS> ring{dq_shared + T::kStageOff};
  const int hb = a.H * a.B, w = blockIdx.x;
  const int q0 = (a.Lq / kBT - 1 - w / hb) * kBT;
  const int h = w % a.H, b = w % hb / a.H;
  const int hk = h / (a.H / a.Hkv), offset = a.Lk - a.Lq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = warp / 2 * 4 + lane / 8, tx = warp % 2 * 8 + lane % 8;
  const float scale2 = a.scale * kLog2e;  // logits in log2 units
  const float fill2 = kNegInf * kLog2e;   // the -1e30 fill, in log2 units

  load_transposed<D, E>(qt, a.q, b, a.Lq, a.H, h, q0);
  load_transposed<D, E>(gt, a.dout, b, a.Lq, a.H, h, q0);
  store_q_rows(rows, q_row_value(a, b, h, q0));

  // the stream of chunks, k tile after k tile: V's chunks 0 .. kC - 1
  // (dP), K's (S), then K's 0 .. kC - 2 again (dQ)
  const size_t k_ld = static_cast<size_t>(a.Hkv) * D;  // floats a key
  const float* kg = static_cast<const float*>(a.k) +
                    (static_cast<size_t>(b) * a.Lk * a.Hkv + hk) * D;
  const float* vg = static_cast<const float*>(a.v) +
                    (static_cast<size_t>(b) * a.Lk * a.Hkv + hk) * D;
  // _kb_lo: no k tile left of the window's reach runs
  const int lo = (a.causal && a.window > 0)
                     ? max(0, floor_div(q0 + offset - (a.window - 1), kBT))
                     : 0;
  const int kb_first = fwd_k_tile<D>(a, q0, lo, offset);
  int pkb = kb_first, pj = 0;
  auto produce = [&]() {
    if (pkb < 0) {
      ring.skip();
      return;
    }
    ring.fetch((pj < kC ? vg : kg) + static_cast<size_t>(pkb) * kBT * k_ld +
                   pj % kC * 64,
               k_ld);
    if (++pj == 3 * kC - 1) {
      pj = 0;
      pkb = fwd_k_tile<D>(a, q0, pkb + 1, offset);
    }
  };
  auto step = [&]() {
    const float* chunk = ring.next();
    produce();
    return chunk;
  };
  for (int s = 0; s < kS - 1; ++s) produce();

  float dq[kC][4][4];
#pragma unroll
  for (int n = 0; n < kC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][i][e] = 0.f;

  for (int kb = kb_first; kb >= 0; kb = fwd_k_tile<D>(a, q0, kb + 1, offset)) {
    const int k0 = kb * kBT;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    // dP = dO.V^T over V's chunks, then S = Q.K^T over K's
#pragma unroll 1
    for (int c = 0; c < kC; ++c)
      chunk_product(dp, gt + c * 64 * kBLd, step(), ty, tx);
    const float* ks = nullptr;
#pragma unroll 1
    for (int c = 0; c < kC; ++c) {
      ks = step();
      chunk_product(s, qt + c * 64 * kBLd, ks, ty, tx);
    }

    // s becomes dS = P (dP - delta) scale; a tile no pair of which is
    // masked skips the per-element rule
    const bool interior = bwd_interior(a, q0, k0, offset);
    const float4 lse2 = ld4(rows + 4 * ty), dlt = ld4(rows + kBT + 4 * ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x;
        if (interior) {
          x = fmaf(s[i][j], scale2, -at(lse2, i));
        } else {
          const int kpos = k0 + tx + 16 * j;
          const bool ok = valid(
              a, q0 + 4 * ty + i, kpos, offset,
              __float_as_int(rows[2 * kBT + 4 * ty + i]),
              a.kseg ? __ldg(a.kseg + static_cast<size_t>(b) * a.Lk + kpos)
                     : 0);
          x = (ok ? s[i][j] * scale2 : fill2) - at(lse2, i);
        }
        s[i][j] = ex2(x) * (dp[i][j] - at(dlt, i)) * a.scale;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * kBLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // dQ += dS.K over K's chunks: the last one still in its stage, then
    // the others streamed again
    rows_product(dq[kC - 1], dst, ks, ty, tx);
#pragma unroll
    for (int n = 0; n < kC - 1; ++n)
      rows_product(dq[n], dst, step(), ty, tx);
  }
  cp_async_wait<0>();  // the stream's empty tail groups

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* orow =
        out + ((static_cast<size_t>(b) * a.Lq + q0 + 4 * ty + i) * a.H + h) *
                  D;
#pragma unroll
    for (int n = 0; n < kC; ++n)
      *reinterpret_cast<float4*>(orow + 64 * n + 4 * tx) = make_float4(
          dq[n][i][0], dq[n][i][1], dq[n][i][2], dq[n][i][3]);
  }
}

// dk/dv: one CTA per (64-key tile, kv head, batch row), the heaviest
// causal k tiles first (k tile 0 sees every q tile; a 1-D grid, k tile
// slowest).
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, DkvTile<D>::kMinBlocks)
    flash_simple_bwd_dkv_kernel(const Args a) {
  static_assert(std::is_same_v<E, float>, "the SIMT backward takes f32");
  using T = DkvTile<D>;
  constexpr int kC = T::kChunks, kS = T::kStages;
  extern __shared__ __align__(16) float dkv_shared[];
  float* kt = dkv_shared;                 // K^T [D][kBLd]
  float* vt = dkv_shared + D * kBLd;      // V^T [D][kBLd]
  float* pq = dkv_shared + T::kPOff;      // P [kBT][kBLd], q-major
  float* dsq = dkv_shared + T::kDsOff;    // dS [kBT][kBLd], q-major
  float* rows = dkv_shared + T::kRowOff;  // lse2, delta, q segment ids
  int* ksg = reinterpret_cast<int*>(rows + 3 * kBT);  // key segment ids
  Ring<kS> ring{dkv_shared + T::kStageOff};
  const int hb = a.Hkv * a.B, w = blockIdx.x;
  const int k0 = w / hb * kBT;
  const int hk = w % a.Hkv, b = w % hb / a.Hkv;
  const int group = a.H / a.Hkv, offset = a.Lk - a.Lq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = warp / 2 * 4 + lane / 8, tx = warp % 2 * 8 + lane % 8;
  const float scale2 = a.scale * kLog2e;  // logits in log2 units
  const float fill2 = kNegInf * kLog2e;   // the -1e30 fill, in log2 units

  load_transposed<D, E>(kt, a.k, b, a.Lk, a.Hkv, hk, k0);
  load_transposed<D, E>(vt, a.v, b, a.Lk, a.Hkv, hk, k0);
  if (threadIdx.x < kBT)
    ksg[threadIdx.x] =
        a.kseg ? a.kseg[static_cast<size_t>(b) * a.Lk + k0 + threadIdx.x] : 0;

  // the stream of chunks, q tile after q tile of each q head of the
  // group: Q's chunks 0 .. kC - 1 (S^T), dO's (dP^T), Q's again (dK), then
  // dO's 0 .. kC - 2 again (dV)
  const size_t q_ld = static_cast<size_t>(a.H) * D;  // floats a q row
  const float* qg =
      static_cast<const float*>(a.q) + static_cast<size_t>(b) * a.Lq * q_ld;
  const float* gg = static_cast<const float*>(a.dout) +
                    static_cast<size_t>(b) * a.Lq * q_ld;
  // _qb_lo: under the causal mask no q tile before this one sees k0
  const int qb_lo = a.causal ? max(0, floor_div(k0 - offset, kBT)) : 0;
  const int qb_first = bwd_q_tile(a, k0, qb_lo, offset);
  int pj = 0, pqb = qb_first, pc = 0;  // q head of the group, q tile, chunk
  auto produce = [&]() {
    if (pqb < 0) {
      ring.skip();
      return;
    }
    ring.fetch((pc / kC % 2 ? gg : qg) +
                   (static_cast<size_t>(pqb) * kBT * a.H + hk * group + pj) *
                       D +
                   pc % kC * 64,
               q_ld);
    if (++pc == 4 * kC - 1) {
      pc = 0;
      pqb = bwd_q_tile(a, k0, pqb + 1, offset);
      if (pqb < 0 && ++pj < group) pqb = qb_first;
    }
  };
  auto step = [&]() {
    const float* chunk = ring.next();
    produce();
    return chunk;
  };
  for (int s = 0; s < kS - 1; ++s) produce();

  float dk[kC][4][4], dv[kC][4][4];
#pragma unroll
  for (int n = 0; n < kC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][i][e] = dv[n][i][e] = 0.f;

  for (int j = 0; j < group && qb_first >= 0; ++j) {
    for (int qb = qb_first; qb >= 0; qb = bwd_q_tile(a, k0, qb + 1, offset)) {
      const int q0 = qb * kBT;
      // the tile's row values land in a register while S^T's first chunk
      // is computed; stored to `rows` after it (every thread read the last
      // tile's values steps ago), they are read after a later step
      const float rv = q_row_value(a, b, hk * group + j, q0);
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[i][c] = dpt[i][c] = 0.f;
      // S^T = K.Q^T over Q's chunks
#pragma unroll 1
      for (int c = 0; c < kC; ++c) {
        chunk_product(st, kt + c * 64 * kBLd, step(), ty, tx);
        if (c == 0) store_q_rows(rows, rv);
      }

      // st becomes P, stored q-major (before dP^T or after it: kEarlyP); a
      // tile no pair of which is masked skips the per-element rule
      const bool interior = bwd_interior(a, q0, k0, offset);
      auto store_p = [&]() {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = tx + 16 * c;
          const float lse2 = rows[qc];
          const int qs = __float_as_int(rows[2 * kBT + qc]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x;
            if (interior) {
              x = fmaf(st[i][c], scale2, -lse2);
            } else {
              const bool ok = valid(a, q0 + qc, k0 + 4 * ty + i, offset, qs,
                                    ksg[4 * ty + i]);
              x = (ok ? st[i][c] * scale2 : fill2) - lse2;
            }
            st[i][c] = ex2(x);
          }
          *reinterpret_cast<float4*>(pq + qc * kBLd + 4 * ty) =
              make_float4(st[0][c], st[1][c], st[2][c], st[3][c]);
        }
      };
      if constexpr (T::kEarlyP) store_p();

      // dP^T = V.dO^T over dO's chunks; then dS = P (dP - delta) scale,
      // P read back (this thread's own values)
      const float* gs = nullptr;
#pragma unroll 1
      for (int c = 0; c < kC; ++c) {
        gs = step();
        chunk_product(dpt, vt + c * 64 * kBLd, gs, ty, tx);
      }
      if constexpr (!T::kEarlyP) store_p();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c;
        const float dlt = rows[kBT + qc];
        const float4 pv = ld4(pq + qc * kBLd + 4 * ty);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dpt[i][c] = at(pv, i) * (dpt[i][c] - dlt) * a.scale;
        *reinterpret_cast<float4*>(dsq + qc * kBLd + 4 * ty) =
            make_float4(dpt[0][c], dpt[1][c], dpt[2][c], dpt[3][c]);
      }

      // dV += P^T.dO for dO's last chunk, still in its stage (P stored
      // before dP^T has been visible since dP^T's steps); dK += dS^T.Q
      // over Q's chunks streamed again (dS visible after their first
      // step); then dV over dO's others
      if constexpr (!T::kEarlyP) __syncthreads();
      rows_product(dv[kC - 1], pq, gs, ty, tx);
#pragma unroll
      for (int n = 0; n < kC; ++n) rows_product(dk[n], dsq, step(), ty, tx);
#pragma unroll
      for (int n = 0; n < kC - 1; ++n)
        rows_product(dv[n], pq, step(), ty, tx);
    }
  }
  cp_async_wait<0>();  // the stream's empty tail groups

  float* dk_out = static_cast<float*>(a.out);
  float* dv_out = static_cast<float*>(a.out2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t o =
        ((static_cast<size_t>(b) * a.Lk + k0 + 4 * ty + i) * a.Hkv + hk) * D +
        4 * tx;
#pragma unroll
    for (int n = 0; n < kC; ++n) {
      *reinterpret_cast<float4*>(dk_out + o + 64 * n) =
          make_float4(dk[n][i][0], dk[n][i][1], dk[n][i][2], dk[n][i][3]);
      *reinterpret_cast<float4*>(dv_out + o + 64 * n) =
          make_float4(dv[n][i][0], dv[n][i][1], dv[n][i][2], dv[n][i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// host: launch
// ---------------------------------------------------------------------------

template <int D>
struct Dim {
  static constexpr int value = D;
};

// fn(Dim<D>{}, E{}) for the (element, head dim) pairs every kernel here
// takes: f32 at head_dim 64, 128 and 256
template <typename Fn>
static cudaError_t on_domain(int elem, int D, Fn&& fn) {
  if (elem == kElemF32 && D == 64) return fn(Dim<64>{}, float{});
  if (elem == kElemF32 && D == 128) return fn(Dim<128>{}, float{});
  if (elem == kElemF32 && D == 256) return fn(Dim<256>{}, float{});
  return cudaErrorInvalidValue;
}

// One CTA of kThreads threads per grid entry, with as much of the SM's
// memory given to shared memory as it takes, so that two CTAs fit where a
// kernel's tiles allow them (at head_dim 64 and 128 for the forward, 64
// for dq and dk/dv)
template <typename K>
static cudaError_t launch(K kernel, dim3 grid, int smem, const Args& a,
                          cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

static Args make_args(const void* q, const void* k, const void* v,
                      const void* qseg, const void* kseg, int B, int H,
                      int Hkv, int Lq, int Lk, float scale, int causal,
                      int window) {
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Lq = Lq; a.Lk = Lk;
  a.scale = scale; a.causal = causal; a.window = window;
  return a;
}

}  // namespace kft::simple

extern "C" {

// Each returns a cudaError_t: the launch's own error, 0 when it was
// accepted; cudaErrorInvalidValue for an (elem, D) outside the domain.
int kft_flash_simple_fwd(const void* q, const void* k, const void* v,
                         const void* qseg, const void* kseg, void* out,
                         void* lse, int B, int H, int Hkv, int Lq, int Lk,
                         int D, int elem, float scale, int causal, int window,
                         void* stream) {
  using namespace kft::simple;
  Args a = make_args(q, k, v, qseg, kseg, B, H, Hkv, Lq, Lk, scale, causal,
                     window);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_domain(elem, D, [&](auto dim, auto e) {
    constexpr int kD = decltype(dim)::value;
    using E = decltype(e);
    return launch(flash_simple_fwd_kernel<kD, E>,
                  dim3(Lq / FwdTile<kD>::kBQ * H * B), FwdTile<kD>::kSmem,
                  a, st);
  }));
}

int kft_flash_simple_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* qseg,
                            const void* kseg, void* dq, int B, int H, int Hkv,
                            int Lq, int Lk, int D, int elem, float scale,
                            int causal, int window, void* stream) {
  using namespace kft::simple;
  Args a = make_args(q, k, v, qseg, kseg, B, H, Hkv, Lq, Lk, scale, causal,
                     window);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_domain(elem, D, [&](auto dim, auto e) {
    constexpr int kD = decltype(dim)::value;
    using E = decltype(e);
    return launch(flash_simple_bwd_dq_kernel<kD, E>, dim3(Lq / kBT * H * B),
                  DqTile<kD>::kSmem, a, st);
  }));
}

int kft_flash_simple_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* qseg,
                             const void* kseg, void* dk, void* dv, int B,
                             int H, int Hkv, int Lq, int Lk, int D, int elem,
                             float scale, int causal, int window,
                             void* stream) {
  using namespace kft::simple;
  Args a = make_args(q, k, v, qseg, kseg, B, H, Hkv, Lq, Lk, scale, causal,
                     window);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dk;
  a.out2 = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_domain(elem, D, [&](auto dim, auto e) {
    constexpr int kD = decltype(dim)::value;
    using E = decltype(e);
    return launch(flash_simple_bwd_dkv_kernel<kD, E>,
                  dim3(Lk / kBT * Hkv * B), DkvTile<kD>::kSmem, a, st);
  }));
}

}  // extern "C"
