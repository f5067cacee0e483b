// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu, flash_bwd_dkv.cu): TMA tile loads into a
// ring of shared-memory stages guarded by mbarriers, wgmma on
// 128B-swizzled tiles, setmaxnreg, and the TPU kernels' mask and
// block-skip rules (kubeflow_tpu/ops/flash_attention.py: _block_mask,
// _block_runs) at any tile, with the same -1e30 fill.
//
// Layout: q/out/dO/dq are [B, Lq, H, D] and k/v/dk/dv [B, Lk, Hkv, D],
// contiguous, bf16; lse/delta are [B, H, Lq] f32; segment ids [B, L]
// int32. A tensor map describes one such tensor as 4-D (D, heads, L, B)
// and copies boxes of 64 columns x 1 head x `rows` rows: a [rows, D] tile
// lands in shared memory as D / 64 column blocks of `rows` x 128 bytes,
// 128B-swizzled, which is the layout wgmma reads. No transposed copy
// surrounds the kernels.
#pragma once

// <cuda.h> for CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kft::sm90 {

typedef __nv_bfloat16 bf16;

// two consumer warpgroups (threads 0-255), then one producer warpgroup
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kCols = 64;      // bf16 columns of one 128-byte swizzled row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* lse;    // backward: the forward's row logsumexp
  const float* delta;  // backward: rowsum(dO * O)
  const int* qseg;     // optional
  const int* kseg;     // optional
  bf16* out;           // forward: out; dq: dq; dk/dv: dk
  bf16* out2;          // dk/dv: dv
  float* lse_out;      // forward: lse
  int B, H, Hkv, Lq, Lk;
  float scale;
  int causal, window;
};

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to 1024 bytes: the 128B swizzle
// repeats every 8 rows of 128 bytes, and wgmma's descriptors assume tiles
// start on that period. Launchers allocate 1024 bytes of slack.
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return smem_raw + pad;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the TMA unit and other threads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// far longer than any launch traps, so a lost arrival fails the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    if (spin == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map at coordinates (col, head, row, batch) into
// shared memory; its bytes count against `bar`'s expected transactions.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, counted against `bar` as tma_load.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Registers move from the producer warpgroup to the consumers.
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled operand: start
// address, leading and stride byte offsets, swizzle mode 1 (128 bytes).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// K-major operand: 16 contraction columns starting at `p`, in rows of 128
// bytes whose 8-row groups lie 1024 bytes apart (LBO is unused under the
// 128B swizzle).
__device__ __forceinline__ uint64_t desc_k(const bf16* p) {
  return make_desc(p, 16, 1024);
}

// MN-major operand: 16 contraction rows starting at `p`, each 64 columns
// of N in 128 bytes, 8-row groups 1024 bytes apart. Each instruction reads
// one 64-column block, so the offset between column blocks never applies;
// both offsets are set to the row-group stride.
__device__ __forceinline__ uint64_t desc_mn(const bf16* p) {
  return make_desc(p, 1024, 1024);
}

// Element `c` of column block `c / 64`, row `r`, of a [rows, D] tile as
// TMA lays it out (the swizzle is applied by the hardware on both sides;
// addresses handed to wgmma are those of the unswizzled layout).
__device__ __forceinline__ const bf16* tile_at(const bf16* tile, int rows,
                                               int r, int c) {
  return tile + (c / kCols) * rows * kCols + r * kCols + c % kCols;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin accumulator registers in program order around asynchronous wgmma
// (no read or write of them moves across this point).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A . B^T (+ d if accumulate): A and B K-major,
// bf16, in 128B-swizzled shared memory, given by their descriptors.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) = A . B^T (+ d if accumulate): A and B K-major,
// bf16, in 128B-swizzled shared memory, given by their descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) = A . B^T (+ d if accumulate), N 64 or 128, as above.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 128)
    wgmma_ss_n128(d, a, b, accumulate);
  else
    wgmma_ss_n64(d, a, b, accumulate);
}

// d (64 x 64, f32) += A . B: A (64 x 16, bf16) in registers in the
// accumulator layout (pack_p), B (16 x 64) MN-major (N contiguous), bf16,
// in 128B-swizzled shared memory, given by its descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// Two f32 rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of contraction step kk (16 columns) from a 64 x N f32
// accumulator, rounded to bf16: the accumulator layout of columns
// 16kk..16kk+15 is the register-A layout of wgmma.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N],
                                       int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// masks and block skips
// ---------------------------------------------------------------------------

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// A work item of the persistent fwd and dq grids: one (bq-row q tile,
// q head, batch row), the heaviest causal q tiles first.
struct QItem {
  int qb, h, b;
};
__device__ __forceinline__ QItem q_item(const Args& a, int w, int bq) {
  const int hb = a.H * a.B, r = w % hb;
  return {a.Lq / bq - 1 - w / hb, r % a.H, r / a.H};
}

// _kb_lo: no bk-key tile left of the window's reach can run for the q
// tile at q0
__device__ __forceinline__ int kb_lo(const Args& a, int q0, int bk,
                                     int offset) {
  return (a.causal && a.window > 0)
             ? max(0, floor_div(q0 + offset - (a.window - 1), bk))
             : 0;
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

// No pair of rows [q_lo, q_hi] and keys [k_lo, k_hi] is masked: the causal
// rule lets the last key through to the first row, the window the first
// key to the last row, and there are no segment ids. Such a tile skips the
// per-element mask.
__device__ __forceinline__ bool tile_interior(const Args& a, int q_lo,
                                              int q_hi, int k_lo, int k_hi,
                                              int offset) {
  if (a.qseg) return false;
  if (a.causal && k_hi > q_lo + offset) return false;
  if (a.window > 0 && q_hi + offset - k_lo >= a.window) return false;
  return true;
}

// _block_mask's causal and window rules as a band of distances
// d = qpos + offset - kpos: a pair is valid for band_lo <= d < band_hi.
// Segment ids are compared by the caller.
__device__ __forceinline__ int band_lo(const Args& a) {
  return a.causal ? 0 : -(1 << 30);
}
__device__ __forceinline__ int band_hi(const Args& a) {
  return a.window > 0 ? a.window : 1 << 30;
}

// 2^x on the special-function unit (the softmax works in log2 units).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// ---------------------------------------------------------------------------
// host: tensor maps and launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of a contiguous [B, L, heads, D] bf16 tensor at `base`,
// boxes of 64 columns x 1 head x `rows` rows, 128B swizzle. The driver's
// encoder is looked up through the runtime, so nothing links libcuda.
static cudaError_t make_map(CUtensorMap* map, const void* base, int B, int L,
                            int heads, int D, int rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * L};
  const cuuint32_t box[4] = {kCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace kft::sm90
