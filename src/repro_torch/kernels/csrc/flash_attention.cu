// Flash attention forward for Hopper (sm_90a), bound through a plain C ABI.
//
// Replaces: flash_attention_pallas / flash_attention_kernel in
//   src/repro/kernels/flash_attention/kernel.py (the Pallas TPU kernel).  That
//   kernel needs S to be a multiple of its 128-row blocks and K/V with the
//   query's head count; this one takes any S and K/V with Hkv heads dividing H.
// Computes: out = softmax(q k^T * hd^-0.5 [causal mask]) v for q [B,S,H,hd] and
//   k, v [B,S,Hkv,hd]; query head h reads K/V head h / (H / Hkv).  Scores,
//   running max, running sum and the accumulator are fp32; inputs are f32 or
//   bf16 and the output has the input type.  hd is 64, 128 or 256.
// Bound: at the serving path's shapes (B=4, S=255, H=8, Hkv=1, hd=256, causal)
//   bytes: q, k, v read once and out written once are about 9.4 MB, 2.8 us at
//   3.35 TB/s, against 1.1 us for the 1.1 GFLOP (4 * B * H * hd * S(S+1)/2)
//   at 989 TFLOP/s in bf16.  Longer sequences are bound by operations: at
//   B=1, S=4096, H=8 the 68.7 GFLOP take 69 us at that rate.  chip_smoke.py
//   computes both bounds for each run.
// Two kernels, chosen by the input type (not a fallback: each launch either
// runs its own kernel or returns the error):
//
// bf16, flash_attention_mma_kernel (the serving path): both products on the
//   tensor cores with mma.sync m16n8k16 (bf16 operands, fp32 accumulators),
//   the instruction class of FlashAttention-2 on this card.  A block is 8
//   warps in row groups of 16 query rows, in one of two shapes:
//     BQ = 64 query rows: 4 groups of 2 warps, each warp taking one half (32
//       keys) of every 64-key tile, for grids of fewer 128-row blocks than
//       the card has SMs (the serving path: B=4, S=255, H=8 is 128 blocks);
//     BQ = 128: 8 groups of 1 warp (FlashAttention-2's shape at hd 256),
//       which reads each K/V tile once for twice the rows, otherwise.
//   The launch reads the SM count and picks.
//   - Shared memory holds the Q tile and a 2-stage ring of 64-key K and V
//     tiles, all bf16, rows padded by 16 bytes: (BQ + 4 * 64) * (hd * 2 +
//     16) bytes, 165 KB (BQ 64) or 198 KB (BQ 128) at hd=256, one block an
//     SM.  Tiles arrive by 16-byte cp.async (cp.async.cg, commit/wait_group):
//     the loads of key tile j+1 are in flight while tile j is computed.  Rows
//     past S are zero-filled by the copy (src-size 0), so nothing reads past
//     the tensors.  With rows of hd * 2 + 16 bytes the 8 row addresses of an
//     ldmatrix phase start 16 bytes apart and never share a bank, and every
//     address is a per-lane base plus a constant (an XOR swizzle made each a
//     register of its own and spilled at hd=256).
//   - S = Q K^T: Q by ldmatrix.x4, K by ldmatrix.x4 (its rows are the B
//     operand's columns), the fragments of step k+1 loaded before the
//     products of step k.  The online softmax works on the fp32 score
//     fragments in registers, in the log2 domain (ex2.approx); row max and
//     row sum are reduced over the quad of lanes that shares a row with two
//     shuffles.  P is rounded to bf16 in registers and is the A operand of
//     P V directly (the accumulator fragment of two 8-key tiles is the A
//     fragment of one 16-key step); V comes by ldmatrix.x4.trans.  Rounding
//     P to bf16 is this kernel's one departure from fp32 softmax: about
//     2^-9 relative per probability, inside the bf16 tolerance of 3e-2.
//   - Registers: at hd=256 the output accumulator is 16 x 256 fp32 per warp,
//     128 registers a thread.  With all 64 keys of a tile a warp also holds
//     32 score registers; loading the fragments of step k+1 before the
//     products of step k (rather than each just before its use) let ptxas
//     fit both shapes in 255 registers with no spill at hd 64, 128 and 256
//     (the build's -Xptxas -v report, printed by chip_smoke.py phase 2).  In
//     BQ 64 the two warps of a group keep their own max, sum and accumulator
//     over disjoint keys; at the end the second hands them to the first
//     through shared memory, which merges them.
//   - Any S: the ragged tails of q and k are masked per 16x8 fragment
//     element.  In causal mode key tiles past the query tile's diagonal are
//     skipped and only the diagonal and ragged tiles are masked.  A row with
//     no valid key writes zeros (l is clamped at 1e-30).  Block y computes
//     query tile ceil(S/BQ)-1-y, so the heaviest causal tiles start first.
//   - The output goes through the group's own Q rows in shared memory and
//     leaves in 16-byte stores.  Pointers must be 16-byte aligned.
//   - Each warp reads whole K and V fragments from shared memory for its 16
//     query rows: per 64-key tile a block of BQ 64 issues 640 ldmatrix.x4
//     (320 KB) for 1024 mma.  That traffic, the two barriers a tile and the
//     softmax between the products set its pace, not the tensor cores or
//     HBM, and it stays behind scaled_dot_product_attention (PERF.md).
//     wgmma, which reads B straight from shared memory for 64 rows at once,
//     and TMA are the next step.
//
// f32, flash_attention_kernel (parity checks): the products run on the FP32
//   pipes, since TF32 tensor cores cannot meet the fp32 tolerance of 3e-5.
//   One block of 256 threads per (batch*head, 64-query tile).  The Q tile,
//   pre-scaled, is held in shared memory as fp32; the block loops over
//   32-key tiles of K and V in shared memory and keeps an online softmax in
//   fp32.  Four threads share a query row: each computes 8 of the tile's 32
//   scores and owns hd/4 accumulator columns in registers; row max and sum
//   are reduced with warp shuffles.  Rows are padded by one float so the
//   threads of a warp hit distinct banks.  Causal tiles past the diagonal are
//   skipped; query rows and keys past S are masked.
//
// Both kernels take more than the 48 KB default of shared memory at hd=256,
// so every launch first raises the dynamic limit with cudaFuncSetAttribute;
// a refused launch is reported by cudaGetLastError.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kRowThreads = kThreads / kBlockQ;
constexpr int kKeysPerThread = kBlockK / kRowThreads;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (HD + 1) + (size_t)kBlockQ * (kBlockK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int H, int Hkv, int causal, float scale) {
  constexpr int LD = HD + 1;              // padded row length in floats
  constexpr int kColsPerThread = HD / kRowThreads;
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBlockQ][LD]
  float* ks = qs + kBlockQ * LD;          // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;          // [kBlockK][LD]
  float* ps = vs + kBlockK * LD;          // [kBlockQ][kBlockK + 1]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const size_t q_stride = (size_t)H * HD;     // elements between sequence rows
  const size_t kv_stride = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)hk * HD;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)hk * HD;
  T* ob = o + (size_t)b * S * q_stride + (size_t)h * HD;

  const int tid = threadIdx.x;
  for (int idx = tid; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    qs[r * LD + c] = (q0 + r < S) ? to_float(qb[(size_t)(q0 + r) * q_stride + c]) * scale : 0.f;
  }

  const int row = tid / kRowThreads;      // query row within the tile
  const int sub = tid % kRowThreads;      // lane within the row's 4 threads
  const int qpos = q0 + row;
  float acc[kColsPerThread];              // columns sub, sub+4, sub+8, ...
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int kv_end = causal ? min(S, q0 + kBlockQ) : S;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBlockK * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD;
      const bool ok = k0 + r < S;
      ks[r * LD + c] = ok ? to_float(kb[(size_t)(k0 + r) * kv_stride + c]) : 0.f;
      vs[r * LD + c] = ok ? to_float(vb[(size_t)(k0 + r) * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[kKeysPerThread];              // keys sub, sub+4, ..., sub+28
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[row * LD + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[j] += qd * ks[(sub + kRowThreads * j) * LD + d];
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int kpos = k0 + sub + kRowThreads * j;
      const bool valid = kpos < S && (!causal || kpos <= qpos);
      s[j] = valid ? s[j] : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;  // row fully masked so far
    const float alpha = expf(m - m_use);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p = expf(s[j] - m_use);
      ps[row * (kBlockK + 1) + sub + kRowThreads * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) acc[i] *= alpha;
    __syncwarp();  // a row's P is written and read by the same warp
    for (int j = 0; j < kBlockK; ++j) {
      const float p = ps[row * (kBlockK + 1) + j];
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) acc[i] += p * vs[j * LD + sub + kRowThreads * i];
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = ob + (size_t)qpos * q_stride;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) from_float(acc[i] * inv, orow + sub + kRowThreads * i);
  }
}

// ------------------------------------------------------------ bf16, tensor cores
// A block is 8 warps in row groups of 16 query rows: BQ = 64 query rows
// (4 groups of 2 warps, each warp taking half of every key tile) or BQ = 128
// (8 groups of 1 warp).
constexpr int kMmaBlockK = 64;   // keys a K/V tile
constexpr int kMmaThreads = 256;

// Tile rows are padded by 16 bytes: HD * 2 is a multiple of 128, so the 8
// row addresses of an ldmatrix phase start 16 bytes apart in the 128-byte
// bank window and never collide.
template <int HD>
__host__ __device__ constexpr int row_bytes() { return HD * 2 + 16; }

template <int HD, int BQ>
constexpr size_t mma_smem_bytes() {  // Q tile + 2 stages of K and V tiles, bf16
  return (size_t)(BQ + 4 * kMmaBlockK) * row_bytes<HD>();
}

// Byte offset of element (r, c) in a padded [rows][HD] bf16 tile.
template <int HD>
__device__ __forceinline__ uint32_t off(int r, int c) {
  return (uint32_t)(r * row_bytes<HD>() + c * 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ROWS rows of HD bf16 from src (row stride `stride` elements), rows from
// row0, into a padded tile at shared address dst; rows at or past S are
// zero-filled.  One 16-byte cp.async per chunk, spread over the block.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          size_t stride, int row0, int S) {
  constexpr int kChunks = HD / 8;
  static_assert((ROWS * kChunks) % kMmaThreads == 0, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks, ch = i % kChunks;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* g = src + (size_t)(ok ? row0 + r : 0) * stride + ch * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst + off<HD>(r, ch * 8)),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16x16 bf16 A (row), a 16x8 bf16 B (col) and a 16x8 fp32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (2 ulp; 2^-inf = 0), without exp2f's denormal scaling
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): an fp32
// accumulator d[0..3] holds rows g, g, g+8, g+8 and columns 2t, 2t+1, 2t,
// 2t+1 of its 16x8 tile; so r = e / 2 picks the row half of element e.
template <int HD, int BQ>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                               int S, int H, int Hkv, int causal, float scale_log2) {
  constexpr int kGroups = BQ / 16;            // row groups of 16 query rows
  constexpr int kSplit = kMmaThreads / 32 / kGroups;   // warps a group
  constexpr uint32_t kTileBytes = kMmaBlockK * row_bytes<HD>();
  constexpr int kKeys = kMmaBlockK / kSplit;   // keys of each tile a warp takes
  constexpr int kNS = kKeys / 8;        // 8-key column tiles of the warp's scores
  constexpr int kND = HD / 8;           // 8-column tiles of the output
  extern __shared__ __align__(128) unsigned char tiles[];
  const uint32_t qs = smem_u32(tiles);
  const uint32_t ks0 = qs + BQ * row_bytes<HD>();   // stage st at ks0 + st * kTileBytes
  const uint32_t vs0 = ks0 + 2 * kTileBytes;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Hkv * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_stride + (size_t)hk * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_stride + (size_t)hk * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * q_stride + (size_t)h * HD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp % kGroups) * 16;     // the warp's first row in the tile
  const int kpart = warp / kGroups;           // keys kpart * kKeys .. of every tile
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + kMmaBlockK - 1) / kMmaBlockK;

  load_tile<HD, BQ>(qs, qb, q_stride, q0, S);
  load_tile<HD, kMmaBlockK>(ks0, kb, kv_stride, 0, S);
  load_tile<HD, kMmaBlockK>(vs0, vb, kv_stride, 0, S);
  cp_async_commit();

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of rows g and g+8, log2 units
  float l[2] = {0.f, 0.f};               // this thread's share of their running sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {   // tile kt+1 into the other stage, freed at the end of kt-1
      load_tile<HD, kMmaBlockK>(ks0 + (st ^ 1) * kTileBytes, kb, kv_stride, (kt + 1) * kMmaBlockK, S);
      load_tile<HD, kMmaBlockK>(vs0 + (st ^ 1) * kTileBytes, vb, kv_stride, (kt + 1) * kMmaBlockK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile kt (and Q) landed for every thread
    const uint32_t ks = ks0 + st * kTileBytes, vs = vs0 + st * kTileBytes;

    // scores of the warp's 16 rows against its kKeys keys of the tile
    float s[kNS][4];
#pragma unroll
    for (int j = 0; j < kNS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    uint32_t qa[2][4], kf[2][kNS / 2][4];   // fragments of steps kk and kk+1
    auto load_qk = [&](int kk, int buf) {
      ldmatrix_x4(qa[buf], qs + off<HD>(wrow + (lane & 7) + ((lane >> 3) & 1) * 8,
                                        kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < kNS / 2; ++nn)
        ldmatrix_x4(kf[buf][nn],
                    ks + off<HD>(kpart * kKeys + nn * 16 + (lane & 7) + (lane >> 4) * 8,
                                 kk * 16 + ((lane >> 3) & 1) * 8));
    };
    load_qk(0, 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      if (kk + 1 < HD / 16) load_qk(kk + 1, (kk + 1) & 1);
#pragma unroll
      for (int nn = 0; nn < kNS / 2; ++nn) {
        mma_bf16(s[2 * nn], qa[kk & 1], kf[kk & 1][nn][0], kf[kk & 1][nn][1]);
        mma_bf16(s[2 * nn + 1], qa[kk & 1], kf[kk & 1][nn][2], kf[kk & 1][nn][3]);
      }
    }

    const int k0 = kt * kMmaBlockK;
    if (k0 + kMmaBlockK > S || (causal && k0 + kMmaBlockK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kpart * kKeys + 8 * j + 2 * t + (e & 1);
          const int row = q0 + wrow + g + (e >> 1) * 8;
          if (key >= S || (causal && key > row)) s[j][e] = -INFINITY;
        }
      }
    }

    // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;   // row fully masked so far
      const float alpha = fast_exp2(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = fast_exp2(s[j][e] * scale_log2 - m_use);
          sum += s[j][e];
        }
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // acc += P V: P in bf16 from registers, V by transposing ldmatrix
    constexpr int kPV = (kKeys / 16) * (kND / 2);
    uint32_t vf[2][4];
    auto load_v = [&](int i, int buf) {
      const int kk = i / (kND / 2), nn = i % (kND / 2);
      ldmatrix_x4_trans(vf[buf], vs + off<HD>(kpart * kKeys + kk * 16 + (lane & 7) +
                                                  ((lane >> 3) & 1) * 8,
                                              nn * 16 + (lane >> 4) * 8));
    };
    load_v(0, 0);
#pragma unroll
    for (int i = 0; i < kPV; ++i) {
      const int kk = i / (kND / 2), nn = i % (kND / 2);
      if (i + 1 < kPV) load_v(i + 1, (i + 1) & 1);
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_bf16(acc[2 * nn], a, vf[i & 1][0], vf[i & 1][1]);
      mma_bf16(acc[2 * nn + 1], a, vf[i & 1][2], vf[i & 1][3]);
    }
    __syncthreads();   // every warp is done with stage st before it is loaded again
  }

  if constexpr (kSplit == 2) {
    // The two warps of a row group saw disjoint keys.  The second hands its
    // max, sum and accumulator to the first through the K/V ring's memory,
    // laid out [row group][value][lane] so that a warp's accesses are
    // consecutive words, and leaves; the first merges them.
    constexpr int kState = 4 * kND + 4;
    static_assert(kSplit == 1 || kGroups * kState * 32 * sizeof(float) <= 4 * kTileBytes,
                  "the state fits the ring");
    float* state = reinterpret_cast<float*>(tiles + BQ * row_bytes<HD>()) +
                   (warp % kGroups) * kState * 32 + lane;
    if (kpart == 1) {
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) state[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        state[(4 * kND + r) * 32] = m[r];
        state[(4 * kND + 2 + r) * 32] = l[r];
      }
    }
    __syncthreads();
    if (kpart == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m2 = state[(4 * kND + r) * 32], l2 = state[(4 * kND + 2 + r) * 32];
      const float m_new = fmaxf(m[r], m2);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float c1 = fast_exp2(m[r] - m_use), c2 = fast_exp2(m2 - m_use);
      l[r] = l[r] * c1 + l2 * c2;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        acc[n][2 * r] = acc[n][2 * r] * c1 + state[(4 * n + 2 * r) * 32] * c2;
        acc[n][2 * r + 1] = acc[n][2 * r + 1] * c1 + state[(4 * n + 2 * r + 1) * 32] * c2;
      }
    }
  }

  // normalise and stage the warp's rows in its own Q rows (no other warp
  // reads them), then store 16-byte chunks of whole rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kND; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(tiles + off<HD>(wrow + g + 8 * r, n * 8 + 2 * t)) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = wrow + i / kChunks, ch = i % kChunks;
    if (q0 + r < S) {
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * q_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(tiles + off<HD>(r, ch * 8));
    }
  }
}

// ------------------------------------------------------------ launches
template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                       int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<float, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockQ - 1) / kBlockQ));
  flash_attention_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int HD, int BQ>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                       int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD, BQ>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_mma_kernel<HD, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  flash_attention_mma_kernel<HD, BQ><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, Hkv, causal,
      scale * 1.4426950408889634f);   // scores in log2 units, for ex2
  return cudaGetLastError();
}

// 128-row blocks read each K/V tile once for twice the rows, but give half
// the blocks: they are taken when they still fill every SM once.
template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * ((S + 127) / 128) >= sms)
    return launch_mma<HD, 128>(q, k, v, o, B, S, H, Hkv, causal, scale, stream);
  return launch_mma<HD, 64>(q, k, v, o, B, S, H, Hkv, causal, scale, stream);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int Hkv, int causal, float scale, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<HD>(q, k, v, o, B, S, H, Hkv, causal, scale, stream);
    case 1: return launch_bf16<HD>(q, k, v, o, B, S, H, Hkv, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int Hkv, int hd, int causal, float scale,
                                   int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((S + kBlockQ - 1) / kBlockQ > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)launch<64>(q, k, v, o, B, S, H, Hkv, causal, scale, dtype, s);
    case 128: return (int)launch<128>(q, k, v, o, B, S, H, Hkv, causal, scale, dtype, s);
    case 256: return (int)launch<256>(q, k, v, o, B, S, H, Hkv, causal, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Message for a cudaError_t returned by any entry point of this library.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
