// Shared pieces of the flash-attention dq kernel for Hopper (sm_90a)
// (flash_bwd.cu); the forward and dk/dv kernels build on flash_sm90.cuh.
//
// Layout: q/out/dq are [B, Lq, H, D] and k/v/dk/dv are [B, Lk, Hkv, D],
// contiguous, bf16; lse/delta are [B, H, Lq] f32; segment ids are
// [B, L] int32. Grouped-query attention reads kv head h / (H / Hkv).
//
// Tiling: one CTA of 4 warps owns a 64-row tile of q rows; each warp owns
// 16 of those rows and keeps its products in mma.sync m16n8k16
// accumulators. The k/v tiles stream through shared memory 64 rows at a
// time. The mask and block-skip rules are those of the TPU kernels
// (kubeflow_tpu/ops/flash_attention.py: _block_mask, _block_runs), with
// the same -1e30 fill, so a row no key may attend comes out exactly as
// the plain version computes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kft {

constexpr int kTile = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 of padding per shared row: no bank conflicts
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;      // backward only
  const float* lse;      // backward only
  const float* delta;    // backward only
  const int* qseg;       // optional
  const int* kseg;       // optional
  bf16* out;             // forward: out; dq kernel: dq; dkv kernel: dk
  bf16* out2;            // dkv kernel: dv
  float* lse_out;        // forward only
  int B, H, Hkv, Lq, Lk;
  float scale;
  int causal, window;
};

// D = C + A.B for one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring bf16 of one shared row as one register.
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from two shared rows (a transposed read) as one register.
__device__ __forceinline__ uint32_t ld_pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(*lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(*hi)) << 16);
}

// Two f32 rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x D tile of rows `ld` elements apart, into shared rows D + kPad
// apart, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// The A fragments of this warp's 16 rows of a staged 64 x D tile.
template <int D>
__device__ __forceinline__ void load_frags(uint32_t a[][4], const bf16* s,
                                           int r0, int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld32(s + r0 * LD + kk * 16 + t * 2);
    a[kk][1] = ld32(s + (r0 + 8) * LD + kk * 16 + t * 2);
    a[kk][2] = ld32(s + r0 * LD + kk * 16 + 8 + t * 2);
    a[kk][3] = ld32(s + (r0 + 8) * LD + kk * 16 + 8 + t * 2);
  }
}

// acc[n] (16 x 8, n over the 64 rows of the staged tile `s`) = A . s^T:
// the product of this warp's 16 rows with every row of the tile.
template <int D>
__device__ __forceinline__ void mma_rows(float acc[kTile / 8][4],
                                         const uint32_t a[][4], const bf16* s,
                                         int g, int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* p = s + (n * 8 + g) * LD + kk * 16 + t * 2;
      mma_bf16(acc[n], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

// acc[n] (16 x 8, n over D / 8) += P . s, where P is 16 x 64 in the
// accumulator layout of mma_rows (rounded to bf16 here, as the TPU
// kernels cast p / ds to the operand type) and s is a staged 64 x D tile.
template <int D>
__device__ __forceinline__ void mma_cols(float acc[D / 8][4],
                                         const float p[kTile / 8][4],
                                         const bf16* s, int g, int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* rows = s + (kk * 16 + t * 2) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* p0 = rows + n * 8;
      mma_bf16(acc[n], a, ld_pair(p0, p0 + LD),
               ld_pair(p0 + 8 * LD, p0 + 9 * LD));
    }
  }
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// _block_runs: can the (qb, kb) tile pair hold any valid logit?
__device__ __forceinline__ bool block_runs(const FlashArgs& a, int qb, int kb,
                                           int offset) {
  bool run = true;
  if (a.causal) run = kb * kTile <= qb * kTile + (kTile - 1) + offset;
  if (a.window > 0)
    run = run && (qb * kTile + offset) - (kb * kTile + kTile - 1) < a.window;
  return run;
}

// _block_mask for one (query, key) pair; segment ids compared by caller.
__device__ __forceinline__ bool pair_valid(const FlashArgs& a, int qpos,
                                           int kpos, int offset) {
  if (a.causal && qpos + offset < kpos) return false;
  if (a.window > 0 && qpos + offset - kpos >= a.window) return false;
  return true;
}

// Max and sum over the four threads of a quad (they share one row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

}  // namespace kft
