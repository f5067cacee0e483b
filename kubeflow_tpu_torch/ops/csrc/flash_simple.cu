// Flash attention for the rest of the reference's domain, in SIMT code:
// a forward (out and lse) and a dk/dv kernel for f32 at head_dim 64, 128
// and 256, and a dq kernel for those and for bf16 and f16 at head_dim
// 256, each templated on (head_dim D, element type E).
//
// Replaces, for those inputs, the Pallas TPU kernels `_fwd_kernel`,
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (kubeflow_tpu/ops/
// flash_attention.py), which take any dtype at head_dim 64, 128 or 256;
// the wgmma kernels take the 2-byte types at head_dim 64 and 128
// (flash_fwd.cu, flash_bwd.cu, flash_bwd_dkv.cu) and at 256 the forward
// and dk/dv (flash_fwd.cu, flash_bwd_dkv_split.cu). Every product here
// is an f32 FMA on the CUDA cores: f32 stays f32, as in the reference's
// kernel (a TF32 tensor-core product would round the operands to 10 bits
// and compute another function), and bf16/f16 operands are widened to
// f32 in shared memory, with dS rounded to E before its product, as the
// TPU kernel's ds.astype.
//
// Bound: the products (2 L^2 D FLOPs per (batch, head) for the forward
// under a causal mask, 3 and 4 times that for dq and dk/dv) over the
// f32 FMA rate, far above the bytes of q/k/v/out: operations bound.
// Design, simple first: one CTA of 256 threads (16 x 16) per (q tile, q
// head, batch row) for the forward and dq, per (k tile, kv head, batch
// row) for dk/dv, which walks the q tiles of every q head of its GQA
// group; operand tiles in shared memory as f32, rows padded to D + 1
// floats, so the 16 threads of a half-warp reading 16 rows at one column
// hit 16 banks; each thread holds its rows' running max and sum, its
// block of S (4 or 2 rows x 4 keys) and D / 16 columns of its rows'
// accumulators in registers; P (or dS) passes through shared memory to
// the second product. The skip and mask rules are the TPU kernels'
// (_block_runs, _kb_lo, _qb_lo; end-aligned causal offset Lk - Lq,
// window, segment ids, the -1e30 fill), so a row no key may attend
// averages the keys of the tiles that ran, as there.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kft::simple {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr int kThreads = 256;  // 16 rows x 16 columns of threads
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// the launchers' element codes (ELEM in ops/flash_attention.py)
constexpr int kElemBf16 = 0, kElemF16 = 1, kElemF32 = 2;

// KERNEL_TILES["flash_simple_*"]: (q rows, keys) of a tile by head dim.
// At D 256 a 64-row tile of q, dO, K and V in f32 would pass the 227 KB
// of shared memory a block may hold, so one side halves.
template <int D>
struct Tile {
  static constexpr int kBQ = D == 256 ? 32 : 64, kBK = 64;         // fwd, dq
  static constexpr int kDkvBQ = 64, kDkvBK = D == 256 ? 32 : 64;  // dk/dv
};

template <typename E>
__device__ __forceinline__ float to_f(E x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<f16>(f16 x) {
  return __half2float(x);
}

template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ f16 from_f<f16>(float x) {
  return __float2half_rn(x);
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

// Max and sum over the 16 threads of a half-warp (they share rows).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
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

template <int D>
constexpr int fwd_smem() {
  constexpr int bq = Tile<D>::kBQ, bk = Tile<D>::kBK;
  return ((bq + 2 * bk) * (D + 1) + bq * (bk + 1) + bk) * 4;
}

// One CTA per (q tile, q head, batch row). Thread (ty, tx) owns q rows
// ty + 16i, keys tx + 16j of each k tile and output columns tx + 16n.
template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
    flash_simple_fwd_kernel(const Args a) {
  constexpr int kBQ = Tile<D>::kBQ, kBK = Tile<D>::kBK, kLd = D + 1;
  constexpr int RQ = kBQ / 16, RK = kBK / 16, RD = D / 16, kPLd = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;     // [kBK][kLd]
  float* vs = ks + kBK * kLd;     // [kBK][kLd]
  float* ps = vs + kBK * kLd;     // [kBQ][kPLd], P rounded to E
  int* ksg = reinterpret_cast<int*>(ps + kBQ * kPLd);  // [kBK]
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kBQ;
  const int hk = h / (a.H / a.Hkv), offset = a.Lk - a.Lq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D, E>(qs, a.q, b, a.Lq, a.H, h, q0, kBQ);
  int qsg[RQ];
  float m[RQ], l[RQ], o[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    qsg[i] = a.qseg ? a.qseg[static_cast<size_t>(b) * a.Lq + q0 + ty + 16 * i]
                    : 0;
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's share of the row sum, summed at the end
#pragma unroll
    for (int n = 0; n < RD; ++n) o[i][n] = 0.f;
  }
  // _kb_lo: no k tile left of the window's reach runs
  const int kb_lo = (a.causal && a.window > 0)
                        ? max(0, floor_div(q0 + offset - (a.window - 1), kBK))
                        : 0;
  for (int kb = kb_lo; kb < a.Lk / kBK; ++kb) {
    const int k0 = kb * kBK;
    if (!block_runs(a, q0, kBQ, k0, kBK, offset)) continue;
    __syncthreads();  // the last tile's readers are done
    load_tile<D, E>(ks, a.k, b, a.Lk, a.Hkv, hk, k0, kBK);
    load_tile<D, E>(vs, a.v, b, a.Lk, a.Hkv, hk, k0, kBK);
    if (a.kseg)
      for (int i = threadIdx.x; i < kBK; i += kThreads)
        ksg[i] = a.kseg[static_cast<size_t>(b) * a.Lk + k0 + i];
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: s becomes P, m and l move on, O is scaled by alpha
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kc = tx + 16 * j;
        const bool ok =
            valid(a, qpos, k0 + kc, offset, qsg[i], a.kseg ? ksg[kc] : 0);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - mn);
        l[i] += p;
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<E>(p);
      }
#pragma unroll
      for (int n = 0; n < RD; ++n) o[i][n] *= alpha;
    }
    __syncthreads();

    // O += P . V
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(ty + 16 * i) * kPLd + kk];
#pragma unroll
      for (int n = 0; n < RD; ++n) {
        const float vv = vs[kk * kLd + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < RQ; ++i) o[i][n] = fmaf(pv[i], vv, o[i][n]);
      }
    }
  }

  E* out = static_cast<E*>(a.out);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const float li = fmaxf(row_sum(l[i]), 1e-20f);
    E* orow = out + ((static_cast<size_t>(b) * a.Lq + qpos) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < RD; ++n) orow[tx + 16 * n] = from_f<E>(o[i][n] / li);
    if (tx == 0)
      a.lse_out[(static_cast<size_t>(b) * a.H + h) * a.Lq + qpos] =
          m[i] + logf(li);
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

// fn(Dim<D>{}, E{}) for the (element, head dim) pairs a kernel takes:
// f32 at every head dim, and with kTwoByte256 (dq) bf16 and f16 at 256
template <bool kTwoByte256, typename Fn>
static cudaError_t on_domain(int elem, int D, Fn&& fn) {
  if (elem == kElemF32 && D == 64) return fn(Dim<64>{}, float{});
  if (elem == kElemF32 && D == 128) return fn(Dim<128>{}, float{});
  if (elem == kElemF32 && D == 256) return fn(Dim<256>{}, float{});
  if constexpr (kTwoByte256) {
    if (elem == kElemBf16 && D == 256) return fn(Dim<256>{}, bf16{});
    if (elem == kElemF16 && D == 256) return fn(Dim<256>{}, f16{});
  }
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
  return static_cast<int>(on_domain<false>(elem, D, [&](auto dim, auto e) {
    constexpr int kD = decltype(dim)::value;
    using E = decltype(e);
    return launch(flash_simple_fwd_kernel<kD, E>,
                  dim3(Lq / Tile<kD>::kBQ, H, B), fwd_smem<kD>(), a, st);
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
  return static_cast<int>(on_domain<true>(elem, D, [&](auto dim, auto e) {
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
  return static_cast<int>(on_domain<false>(elem, D, [&](auto dim, auto e) {
    constexpr int kD = decltype(dim)::value;
    using E = decltype(e);
    return launch(flash_simple_bwd_dkv_kernel<kD, E>,
                  dim3(Lk / Tile<kD>::kDkvBK, Hkv, B), dkv_smem<kD>(), a,
                  st);
  }));
}

}  // extern "C"
