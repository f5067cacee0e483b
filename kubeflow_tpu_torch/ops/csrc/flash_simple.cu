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
// The forward is register-blocked with cp.async streaming (see its
// section). dq and dk/dv, simple first: one CTA of 256 threads (16 x 16)
// per (q tile, q head, batch row) for dq, per (k tile, kv head, batch
// row) for dk/dv, which walks the q tiles of every q head of its GQA
// group; operand tiles in shared memory, rows padded to D + 1 floats, so
// the 16 threads of a half-warp reading 16 rows at one column hit 16
// banks; each thread holds its rows' running values, its block of S (4
// or 2 rows x 4 keys) and D / 16 columns of its rows' accumulators in
// registers; P (or dS) passes through shared memory to the second
// product. The skip and mask rules are the TPU kernels' (_block_runs,
// _kb_lo, _qb_lo; end-aligned causal offset Lk - Lq, window, segment
// ids, the -1e30 fill), so a row no key may attend averages the keys of
// the tiles that ran, as there.
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

// KERNEL_TILES["flash_simple_bwd_*"]: (q rows, keys) of a tile by head
// dim. At D 256 a 64-row tile of q, dO, K and V in f32 would pass the 227
// KB of shared memory a block may hold, so one side halves. The
// forward's tiles are FwdTile below.
template <int D>
struct Tile {
  static constexpr int kBQ = D == 256 ? 32 : 64, kBK = 64;         // dq
  static constexpr int kDkvBQ = 64, kDkvBK = D == 256 ? 32 : 64;  // dk/dv
};

template <typename E>
__device__ __forceinline__ float to_f(E x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}

template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// x rounded to E (the plain version's .to(dtype).float())
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return to_f<E>(from_f<E>(x));
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

// Rows [r0, r0 + rows) of head h, batch row b, of a [B, L, heads, D]
// tensor into `s` as f32, rows D + 1 floats apart; coalesced along D.
template <int D, typename E>
__device__ __forceinline__ void load_tile(float* s, const void* x, int b,
                                          int L, int heads, int h, int r0,
                                          int rows) {
  const E* base = static_cast<const E*>(x) +
                  ((static_cast<size_t>(b) * L + r0) * heads + h) * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    s[r * (D + 1) + c] = to_f<E>(base[static_cast<size_t>(r) * heads * D + c]);
  }
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
// backward: dq
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem() {
  constexpr int bq = Tile<D>::kBQ, bk = Tile<D>::kBK;
  return ((2 * bq + 2 * bk) * (D + 1) + bq * (bk + 1) + bk) * 4;
}

// One CTA per (q tile, q head, batch row), as the forward; it recomputes
// P = exp(S.scale - lse) and dS = P * (dP - delta) * scale
// (`_recompute_p_ds`) and accumulates dQ += dS.K over the k tiles.
template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
    flash_simple_bwd_dq_kernel(const Args a) {
  constexpr int kBQ = Tile<D>::kBQ, kBK = Tile<D>::kBK, kLd = D + 1;
  constexpr int RQ = kBQ / 16, RK = kBK / 16, RD = D / 16, kPLd = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [kBQ][kLd]
  float* gs = qs + kBQ * kLd;     // [kBQ][kLd], dO
  float* ks = gs + kBQ * kLd;     // [kBK][kLd]
  float* vs = ks + kBK * kLd;     // [kBK][kLd]
  float* dss = vs + kBK * kLd;    // [kBQ][kPLd], dS rounded to E
  int* ksg = reinterpret_cast<int*>(dss + kBQ * kPLd);  // [kBK]
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kBQ;
  const int hk = h / (a.H / a.Hkv), offset = a.Lk - a.Lq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D, E>(qs, a.q, b, a.Lq, a.H, h, q0, kBQ);
  load_tile<D, E>(gs, a.dout, b, a.Lq, a.H, h, q0, kBQ);
  int qsg[RQ];
  float lse[RQ], dsc[RQ], dq[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const size_t row = (static_cast<size_t>(b) * a.H + h) * a.Lq + qpos;
    qsg[i] = a.qseg ? a.qseg[static_cast<size_t>(b) * a.Lq + qpos] : 0;
    lse[i] = a.lse[row];
    dsc[i] = a.delta[row];
#pragma unroll
    for (int n = 0; n < RD; ++n) dq[i][n] = 0.f;
  }
  const int kb_lo = (a.causal && a.window > 0)
                        ? max(0, floor_div(q0 + offset - (a.window - 1), kBK))
                        : 0;
  for (int kb = kb_lo; kb < a.Lk / kBK; ++kb) {
    const int k0 = kb * kBK;
    if (!block_runs(a, q0, kBQ, k0, kBK, offset)) continue;
    __syncthreads();
    load_tile<D, E>(ks, a.k, b, a.Lk, a.Hkv, hk, k0, kBK);
    load_tile<D, E>(vs, a.v, b, a.Lk, a.Hkv, hk, k0, kBK);
    if (a.kseg)
      for (int i = threadIdx.x; i < kBK; i += kThreads)
        ksg[i] = a.kseg[static_cast<size_t>(b) * a.Lk + k0 + i];
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], gv[RQ], kv[RK], vv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = qs[(ty + 16 * i) * kLd + d];
        gv[i] = gs[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kv[j] = ks[(tx + 16 * j) * kLd + d];
        vv[j] = vs[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kc = tx + 16 * j;
        const bool ok =
            valid(a, qpos, k0 + kc, offset, qsg[i], a.kseg ? ksg[kc] : 0);
        const float p = expf((ok ? s[i][j] * a.scale : kNegInf) - lse[i]);
        dss[(ty + 16 * i) * kPLd + kc] =
            round_to<E>(p * (dp[i][j] - dsc[i]) * a.scale);
      }
    }
    __syncthreads();

    // dQ += dS . K
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float dv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dv[i] = dss[(ty + 16 * i) * kPLd + kk];
#pragma unroll
      for (int n = 0; n < RD; ++n) {
        const float kk_v = ks[kk * kLd + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dq[i][n] = fmaf(dv[i], kk_v, dq[i][n]);
      }
    }
  }

  E* out = static_cast<E*>(a.out);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    E* orow = out + ((static_cast<size_t>(b) * a.Lq + qpos) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < RD; ++n) orow[tx + 16 * n] = from_f<E>(dq[i][n]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk and dv
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem() {
  constexpr int bq = Tile<D>::kDkvBQ, bk = Tile<D>::kDkvBK;
  return ((2 * bk + 2 * bq) * (D + 1) + 2 * bk * (bq + 1) + 3 * bq) * 4;
}

// One CTA per (k tile, kv head, batch row). It walks every q head of the
// kv head's group and the q tiles that can see its keys, recomputes P^T
// and dS^T, and sums dV += P^T.dO and dK += dS^T.Q over the group in
// registers. Thread (ty, tx) owns keys ty + 16i, q columns tx + 16j of
// each q tile and output columns tx + 16n.
template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
    flash_simple_bwd_dkv_kernel(const Args a) {
  constexpr int kBQ = Tile<D>::kDkvBQ, kBK = Tile<D>::kDkvBK, kLd = D + 1;
  constexpr int RK = kBK / 16, RQ = kBQ / 16, RD = D / 16, kPLd = kBQ + 1;
  extern __shared__ float smem[];
  float* ks = smem;               // [kBK][kLd]
  float* vs = ks + kBK * kLd;     // [kBK][kLd]
  float* qs = vs + kBK * kLd;     // [kBQ][kLd]
  float* gs = qs + kBQ * kLd;     // [kBQ][kLd], dO
  float* pts = gs + kBQ * kLd;    // [kBK][kPLd], P^T rounded to E
  float* dsts = pts + kBK * kPLd; // [kBK][kPLd], dS^T rounded to E
  float* lse_s = dsts + kBK * kPLd;  // [kBQ]
  float* del_s = lse_s + kBQ;        // [kBQ]
  int* qsg_s = reinterpret_cast<int*>(del_s + kBQ);  // [kBQ]
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kBK;
  const int group = a.H / a.Hkv, offset = a.Lk - a.Lq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D, E>(ks, a.k, b, a.Lk, a.Hkv, hk, k0, kBK);
  load_tile<D, E>(vs, a.v, b, a.Lk, a.Hkv, hk, k0, kBK);
  int ksg[RK];
  float dk[RK][RD], dv[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    ksg[i] = a.kseg ? a.kseg[static_cast<size_t>(b) * a.Lk + k0 + ty + 16 * i]
                    : 0;
#pragma unroll
    for (int n = 0; n < RD; ++n) dk[i][n] = dv[i][n] = 0.f;
  }
  // _qb_lo: under the causal mask no q tile before this one sees k0
  const int qb_lo = a.causal ? max(0, floor_div(k0 - offset, kBQ)) : 0;
  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    for (int qb = qb_lo; qb < a.Lq / kBQ; ++qb) {
      const int q0 = qb * kBQ;
      if (!block_runs(a, q0, kBQ, k0, kBK, offset)) continue;
      __syncthreads();
      load_tile<D, E>(qs, a.q, b, a.Lq, a.H, h, q0, kBQ);
      load_tile<D, E>(gs, a.dout, b, a.Lq, a.H, h, q0, kBQ);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const size_t row = (static_cast<size_t>(b) * a.H + h) * a.Lq + q0 + i;
        lse_s[i] = a.lse[row];
        del_s[i] = a.delta[row];
        qsg_s[i] = a.qseg ? a.qseg[static_cast<size_t>(b) * a.Lq + q0 + i] : 0;
      }
      __syncthreads();

      float st[RK][RQ], dpt[RK][RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < RQ; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RK], vv[RK], qv[RQ], gv[RQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = ks[(ty + 16 * i) * kLd + d];
          vv[i] = vs[(ty + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int c = 0; c < RQ; ++c) {
          qv[c] = qs[(tx + 16 * c) * kLd + d];
          gv[c] = gs[(tx + 16 * c) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int c = 0; c < RQ; ++c) {
            st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
            dpt[i][c] = fmaf(vv[i], gv[c], dpt[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < RQ; ++c) {
          const int qc = tx + 16 * c;
          const bool ok = valid(a, q0 + qc, kpos, offset, qsg_s[qc], ksg[i]);
          const float p =
              expf((ok ? st[i][c] * a.scale : kNegInf) - lse_s[qc]);
          pts[(ty + 16 * i) * kPLd + qc] = round_to<E>(p);
          dsts[(ty + 16 * i) * kPLd + qc] =
              round_to<E>(p * (dpt[i][c] - del_s[qc]) * a.scale);
        }
      }
      __syncthreads();

      // dV += P^T . dO, dK += dS^T . Q
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float pv[RK], dsv[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = pts[(ty + 16 * i) * kPLd + qq];
          dsv[i] = dsts[(ty + 16 * i) * kPLd + qq];
        }
#pragma unroll
        for (int n = 0; n < RD; ++n) {
          const float g = gs[qq * kLd + tx + 16 * n];
          const float x = qs[qq * kLd + tx + 16 * n];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv[i][n] = fmaf(pv[i], g, dv[i][n]);
            dk[i][n] = fmaf(dsv[i], x, dk[i][n]);
          }
        }
      }
    }
  }

  E* dk_out = static_cast<E*>(a.out);
  E* dv_out = static_cast<E*>(a.out2);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const size_t at =
        ((static_cast<size_t>(b) * a.Lk + k0 + ty + 16 * i) * a.Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < RD; ++n) {
      dk_out[at + tx + 16 * n] = from_f<E>(dk[i][n]);
      dv_out[at + tx + 16 * n] = from_f<E>(dv[i][n]);
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

template <typename K>
static cudaError_t launch(K kernel, dim3 grid, int smem, const Args& a,
                          cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
    // as much of the SM's memory to shared as it takes, so two CTAs fit
    // at head_dim 64 and 128
    cudaError_t err = cudaFuncSetAttribute(
        flash_simple_fwd_kernel<kD, E>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err) return err;
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
    return launch(flash_simple_bwd_dq_kernel<kD, E>,
                  dim3(Lq / Tile<kD>::kBQ, H, B), dq_smem<kD>(), a, st);
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
                  dim3(Lk / Tile<kD>::kDkvBK, Hkv, B), dkv_smem<kD>(), a,
                  st);
  }));
}

}  // extern "C"
