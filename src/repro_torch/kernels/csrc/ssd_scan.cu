// Chunked Mamba2 SSD scan for Hopper (sm_90a), bound through a plain C ABI.
//
// Replaces: ssd_scan_pallas / ssd_scan_kernel in
//   src/repro/kernels/ssd_scan/kernel.py (the Pallas TPU kernel).  That kernel
//   carries the fp32 state [Hb, P, N] in VMEM scratch from one grid step to the
//   next, which works because a TPU grid runs in order.  A GPU grid does not,
//   and only the state recurrence is sequential, so here the scan is cut into
//   the steps of chunked SSD, each parallel over what it does not depend on.
// Computes, for x [B,S,H,P] (f32 or bf16), dt [B,S,H] f32 (post-softplus),
//   A [H] f32 (negative) and Bc, Cc [B,S,N] of x's type, chunk by chunk (Q
//   rows each, S % Q == 0), with cum = cumsum(dt * A) inside the chunk, tot =
//   cum_{Q-1} and h_c [P,N] fp32 the state at the start of chunk c (h_0 = 0):
//     y[q] = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//            + exp(cum_q) C_q h_c^T
//     h_{c+1} = exp(tot_c) h_c + S_c,  S_c = sum_k dt_k exp(tot_c - cum_k) x_k (x) B_k
//   y is written in x's type; the final state is not returned.
// Bound: at the serving path's shapes (B=4, S=1024, H=48, P=64, N=128, Q=256,
//   bf16) bytes: x read and y written (25 MB each), dt, B and C read (3 MB)
//   are about 53 MB, 16 us at 3.35 TB/s, against about 10 us for the 9.8 GFLOP
//   of the products at 989 TFLOP/s.  chip_smoke.py computes both bounds for
//   each run.
// Design: five launches on the caller's stream, into four fp32 workspaces
//   that the caller allocates (so they live in PyTorch's caching allocator and
//   a CUDA graph can capture the call):
//   1. ssd_scan_cumsum_kernel, one warp per (b, h, chunk): cum by a warp scan,
//      and dt, both written per (b, h) along S, so later steps read rows.
//   2. ssd_scan_cb_kernel, per (b, chunk, 64 x 64 tile on or below the
//      diagonal): C B^T, once for all heads (C and B are one group), into
//      [B, nc, Qp, Qp] (Qp = Q rounded up to 64; 4 MB at the path's shape).
//   3. ssd_scan_state_kernel, per (b, chunk < nc - 1, h, half of n): S_c's
//      [P, 64] half, the weight dt_k exp(tot - cum_k) folded into x as the
//      fragments read it.  The last chunk's state is never needed: y is the
//      only output.
//   4. ssd_scan_pass_kernel, per (b, h, element of [P, N]), sequential over
//      chunks: h_{c+1} = exp(tot_c) h_c + S_c, written over S_c.
//   5. ssd_scan_out_kernel, per (b, chunk, 64-row q tile, h): the inter-chunk
//      term C h_c^T times exp(cum_q), then for each k tile on or below the
//      diagonal M = CB exp(cum_q - cum_k) dt_k and M x added; y rounded once,
//      to x's type.  Below the diagonal the decay factors as exp(cum_q -
//      cum_q0) exp(cum_q0 - cum_k), q0 the tile's first row: neither factor
//      passes 1, two vectors of 64 exps a tile, and M is formed as the
//      fragments read C B^T.  On the diagonal tile M is made in place with an
//      exp per element, 0 above the diagonal selected before the exp.
//   At the path's shape steps 3 and 5 have 1152 and 3072 blocks of 128
//   threads (PR 13's kernel: 192 blocks walking the chunks in turn).  Every
//   product is a 64 x 64 tile over 4 warps in a 2 x 2 grid, each warp 32 x 32
//   in 16 x 8 fragments, read from shared memory in the inputs' type (bf16
//   converts exactly to fp32 in the read) with rows padded so that a warp's
//   reads fall in distinct banks.  Tiles arrive by 16-byte cp.async, no
//   registers holding them in flight: steps 3 and 5 double-buffer their k
//   tiles, loading tile k + 1 while they multiply tile k, and the output
//   kernel fits 4 blocks an SM.  P <= 64 and N <= 128 are zero-padded to
//   those sizes, rows past Q are zero and masked, so any Q (1 .. 4096) works.
// Precision.  bf16: C B^T on the tensor cores in bf16 (mma.sync m16n8k16,
//   fp32 sums): both operands are inputs, so every product is exact.  The
//   products with an fp32 operand (M x, C h^T, (w x)^T B) run in TF32
//   (mma.sync m16n8k8): M, h and w x are rounded to TF32 (cvt.rna, 2^-11
//   relative, under y's own bf16 rounding), x, B and C are bf16 and exact in
//   TF32; sums are fp32.  In the output kernel the TF32 products take the
//   contraction in pairs (k = 2t and 2t + 1 in fragment columns t and t + 4
//   of A and B alike), so a lane reads both from one 8-byte (fp32) or 4-byte
//   (bf16) word.  f32: the same steps, with every product by FP32 FMAs in the
//   same fragment layout (TF32 would miss the fp32 tolerance).
// Tiles above 48 KB of shared memory raise the limit with
//   cudaFuncSetAttribute first; cudaGetLastError reports a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;      // 4 warps, 2 x 2 over a 64 x 64 output tile
constexpr int kTile = 64;          // rows of q and k a tile; P is padded to it
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 4096;
constexpr int kHalfN = kMaxN / 2;  // columns of n a state block takes
constexpr int kPassThreads = 256;
// Padded row lengths.  A lane (g = lane / 4, t = lane % 4) reads its
// fragment elements in pairs along the contraction, from one row (elements
// 2t and 2t + 1 of row g) or from two (element g of rows 2t and 2t + 1).
// Rows of 8 mod 32 words keep one-row 8-byte reads in distinct banks, rows
// of 4 mod 32 words one-row 4-byte (bf16) reads, and rows of 4 mod 16 words
// two-row reads.
constexpr int kLdRow = kMaxN + 8;  // fp32 C [q][n] and h [p][n]
constexpr int kLdM = kTile + 8;    // fp32 C B^T and M [q][k]
constexpr int kLd16 = kMaxN + 8;   // bf16 C [q][n] and B [k][n]: 68 words

template <typename T>
constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;   // tensor cores

// An operand of a TF32 product, rounded to nearest (ties away), as the
// tensor cores read it; unrounded on the FP32 path.
template <bool TC>
__device__ __forceinline__ float operand(float x) {
  if constexpr (TC) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
  } else {
    return x;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes global -> shared, in flight until cp_async_wait; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// An R x C tile of T (rows `stride` elements apart; rows < rows and columns
// < cols valid) to shared memory at dst (rows ld elements apart, 16-byte
// aligned), zero elsewhere: by 16-byte cp.async where whole rows are 16-byte
// multiples and aligned (committed with the caller's group), else element by
// element.
template <int R, int C, typename T>
__device__ __forceinline__ void async_tile(T* dst, int ld, const T* src, size_t stride, int rows,
                                           int cols) {
  constexpr int E = 16 / sizeof(T), G = C / E;
  const bool vec = cols == C && (stride * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    for (int i = threadIdx.x; i < R * G; i += kThreads) {
      const int r = i / G, c = i % G * E;
      cp_async16(dst + r * ld + c, r < rows ? src + (size_t)r * stride + c : src, r < rows);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i / C, c = i % C;
      dst[r * ld + c] = r < rows && c < cols ? src[(size_t)r * stride + c] : T(0.f);
    }
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layout (m16n8, g = lane / 4, t = lane % 4): acc[i][j][e] is row
// m0 + 16 i + g + 8 (e / 2), column n0 + 8 j + 2 t + (e % 2).
__device__ __forceinline__ int frag_row(int m0, int i, int e) {
  return m0 + 16 * i + (threadIdx.x & 31) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int frag_col(int n0, int j, int e) {
  return n0 + 8 * j + 2 * (threadIdx.x & 3) + (e % 2);
}

__device__ __forceinline__ float2 to_float2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_float2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The operands of a product, each read in pairs along the contraction:
// a.pair(m, k) is {A(m, k), A(m, k + 1)}, b.pair(n, k) is {B(k, n), B(k + 1, n)}
// (k even), as fp32; on the tensor cores already exact in TF32.
// A(m, k) = p[m * LD + k]: C, M, C B^T rows (one 8- or 4-byte word a pair).
template <typename T, int LD>
struct RowsA {
  const T* p;
  __device__ __forceinline__ float2 pair(int m, int k) const { return to_float2(p + m * LD + k); }
};
// A(m, k) = p[k * LD + m]: the state product's w x [k][p].
template <int LD>
struct ColsA {
  const float* p;
  __device__ __forceinline__ float2 pair(int m, int k) const {
    return make_float2(p[k * LD + m], p[(k + 1) * LD + m]);
  }
};
// B(k, n) = p[n * LD + k], rounded as a TF32 operand when TC: h [p][n] (and
// B [k][n] of the fp32 C B^T).
template <bool TC, int LD>
struct RowsB {
  const float* p;
  __device__ __forceinline__ float2 pair(int n, int k) const {
    const float2 v = *reinterpret_cast<const float2*>(p + n * LD + k);
    return make_float2(operand<TC>(v.x), operand<TC>(v.y));
  }
};
// B(k, n) = p[k * LD + n]: x [k][p], B [k][n].
template <typename T, int LD>
struct ColsB {
  const T* p;
  __device__ __forceinline__ float2 pair(int n, int k) const {
    return make_float2(to_float(p[k * LD + n]), to_float(p[(k + 1) * LD + n]));
  }
};

// acc += A B over k < K (a multiple of 8), for the warp's MI x NI fragments
// at rows m0 and columns n0.  TC: TF32 mma.sync m16n8k8 with the contraction
// permuted inside each step of 8 — fragment column t carries k = 2t and
// column t + 4 carries k = 2t + 1, in A and B alike — so that a lane takes
// both from one pair.  Otherwise the same sums by FP32 FMAs, element for
// element of the same fragments, in the order of k.
template <bool TC, int MI, int NI, class VA, class VB>
__device__ __forceinline__ void warp_product(float (&acc)[MI][NI][4], VA a, VB b, int m0, int n0,
                                             int K) {
  const int g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  if constexpr (TC) {
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float2 lo = a.pair(m0 + 16 * i + g, k0 + 2 * t);
        const float2 hi = a.pair(m0 + 16 * i + g + 8, k0 + 2 * t);
        af[i][0] = __float_as_uint(lo.x);
        af[i][1] = __float_as_uint(hi.x);
        af[i][2] = __float_as_uint(lo.y);
        af[i][3] = __float_as_uint(hi.y);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float2 v = b.pair(n0 + 8 * j + g, k0 + 2 * t);
        bf[j][0] = __float_as_uint(v.x);
        bf[j][1] = __float_as_uint(v.y);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], af[i], bf[j]);
    }
  } else {
    for (int k = 0; k < K; k += 2) {
      float2 lo[MI], hi[MI], b0[NI], b1[NI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        lo[i] = a.pair(m0 + 16 * i + g, k);
        hi[i] = a.pair(m0 + 16 * i + g + 8, k);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        b0[j] = b.pair(n0 + 8 * j + 2 * t, k);
        b1[j] = b.pair(n0 + 8 * j + 2 * t + 1, k);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          float* d = acc[i][j];
          d[0] = fmaf(lo[i].y, b0[j].y, fmaf(lo[i].x, b0[j].x, d[0]));
          d[1] = fmaf(lo[i].y, b1[j].y, fmaf(lo[i].x, b1[j].x, d[1]));
          d[2] = fmaf(hi[i].y, b0[j].y, fmaf(hi[i].x, b0[j].x, d[2]));
          d[3] = fmaf(hi[i].y, b1[j].y, fmaf(hi[i].x, b1[j].x, d[3]));
        }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Elements (e, e + 1) of a fragment, columns col and col + 1 of one row, to
// p[col], p[col + 1] where they are below `end`: a pair store when `pairs`
// (the row's elements from p are even in number and p is aligned for it).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, int col, int end, bool pairs, float a, float b) {
  if (pairs && col + 1 < end) {
    store2(p + col, a, b);
  } else {
    if (col < end) p[col] = T(a);
    if (col + 1 < end) p[col + 1] = T(b);
  }
}

// 1. cum and dt along S for each (b, h): one warp per (b, h, chunk).
__global__ void __launch_bounds__(kThreads)
    ssd_scan_cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                           float* __restrict__ cum, float* __restrict__ dtt, int B, int S, int H,
                           int chunk) {
  const int nc = S / chunk;
  const long long w = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (w >= (long long)B * H * nc) return;
  const int lane = threadIdx.x & 31;
  const int c = (int)(w % nc), bh = (int)(w / nc), h = bh % H, b = bh / H;
  const float a_h = A[h];
  const float* src = dt + ((size_t)b * S + (size_t)c * chunk) * H + h;
  const size_t out = (size_t)bh * S + (size_t)c * chunk;
  float carry = 0.f;
  for (int r1 = 0; r1 < chunk; r1 += 8 * 32) {   // 8 loads of a lane in flight
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r1 + 32 * i + lane;
      d[i] = r < chunk ? src[(size_t)r * H] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r1 + 32 * i + lane;
      float v = d[i] * a_h;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (r < chunk) {
        cum[out + r] = v;
        dtt[out + r] = d[i];
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// 2. CB[b, c, q, k] = C_q . B_k for one 64 x 64 tile on or below the diagonal.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_cb_kernel(const T* __restrict__ Bc, const T* __restrict__ Cc, float* __restrict__ cb,
                       int S, int N, int chunk) {
  extern __shared__ float4 smem4[];
  const int nc = S / chunk, Qp = (chunk + kTile - 1) / kTile * kTile;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = blockIdx.x - qt * (qt + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile, k0 = kt * kTile;
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;
  const int warp = threadIdx.x / 32, m0 = (warp / 2) * 32, n0 = (warp % 2) * 32;
  const int Nk = (N + 15) / 16 * 16;
  float acc[2][4][4] = {};
  constexpr int LD = kTC<T> ? kLd16 : kLdRow;   // rows of C and B, in T
  T* cs = reinterpret_cast<T*>(smem4);
  T* bs = cs + kTile * LD;
  async_tile<kTile, kMaxN>(cs, LD, Cc + (row0 + q0) * N, N, min(kTile, chunk - q0), N);
  async_tile<kTile, kMaxN>(bs, LD, Bc + (row0 + k0) * N, N, min(kTile, chunk - k0), N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kTC<T>) {
    const int g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(cs);   // rows of kLd16 / 2 words
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(bs);
    constexpr int W = kLd16 / 2;
    for (int kk = 0; kk < Nk; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + 16 * i + g;
        af[i][0] = cw[r * W + kk / 2 + t];
        af[i][1] = cw[(r + 8) * W + kk / 2 + t];
        af[i][2] = cw[r * W + kk / 2 + 4 + t];
        af[i][3] = cw[(r + 8) * W + kk / 2 + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = n0 + 8 * j + g;
        bf[j][0] = bw[r * W + kk / 2 + t];
        bf[j][1] = bw[r * W + kk / 2 + 4 + t];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  } else {
    warp_product<false>(acc, RowsA<T, LD>{cs}, RowsB<false, LD>{bs}, m0, n0, Nk);
  }
  float* out = cb + ((size_t)b * nc + c) * Qp * Qp;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        float* p = out + (size_t)(q0 + frag_row(m0, i, e)) * Qp + k0 + frag_col(n0, j, e);
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][e], acc[i][j][e + 1]);
      }
}

// Shared memory of the state kernel: two buffers of a k tile's x and B half
// as they arrive, in T; the tile's w x in fp32; the weights w.
template <typename T>
struct StateLayout {
  static constexpr int kLdT = kMaxP + 8;   // x [k][p] and B [k][n] rows, in T; kMaxP == kHalfN
  static constexpr int kLdW = kMaxP + 4;   // w x [k][p], fp32, read from two rows
  static constexpr size_t kTileBytes = (size_t)kTile * kLdT * sizeof(T);
  static constexpr size_t kWx = 4 * kTileBytes;
  static constexpr size_t kBytes = kWx + (size_t)kTile * (kLdW + 1) * sizeof(float);
};
static_assert(kMaxP == kHalfN, "x and the B half share a row length");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);   // element 2i in the low half of word i
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// 3. S_c[p, n] = sum_k (w_k x[k, p]) B[k, n], w_k = dt_k exp(tot - cum_k), for
// chunks c < nc - 1 and one half of n (64 columns), into states[b, h, c].
// Tiles arrive by cp.async, double-buffered: the next k tile's loads are in
// flight while the block multiplies this one.  One pass a tile writes w x,
// rounded, in fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    ssd_scan_state_kernel(const T* __restrict__ x, const T* __restrict__ Bc,
                          const float* __restrict__ cum, const float* __restrict__ dtt,
                          float* __restrict__ states, int S, int H, int P, int N, int chunk) {
  using L = StateLayout<T>;
  constexpr bool TC = kTC<T>;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const auto xs = [sm](int buf) { return reinterpret_cast<T*>(sm + 2 * buf * L::kTileBytes); };
  const auto bs = [sm](int buf) {
    return reinterpret_cast<T*>(sm + (2 * buf + 1) * L::kTileBytes);
  };
  float* wx = reinterpret_cast<float*>(sm + L::kWx);   // [kTile (k)][kLdW]
  float* ws = wx + kTile * L::kLdW;                     // [kTile]
  const int halves = gridDim.x / H, h = blockIdx.x / halves;
  const int nb = blockIdx.x % halves * kHalfN, c = blockIdx.y, b = blockIdx.z, nc = S / chunk;
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;
  const float* cumc = cum + ((size_t)b * H + h) * S + (size_t)c * chunk;
  const float* dtc = dtt + ((size_t)b * H + h) * S + (size_t)c * chunk;
  const float tot = cumc[chunk - 1];
  const int warp = threadIdx.x / 32, m0 = (warp / 2) * 32, n0 = (warp % 2) * 32;
  float cum_r = 0.f, dt_r = 0.f;   // row threadIdx.x of the k tile last issued
  const auto issue = [&](int it) {
    const int k0 = it * kTile, rows = min(kTile, chunk - k0);
    async_tile<kTile, kMaxP>(xs(it & 1), L::kLdT, x + ((row0 + k0) * H + h) * P, (size_t)H * P,
                             rows, P);
    async_tile<kTile, kHalfN>(bs(it & 1), L::kLdT, Bc + (row0 + k0) * N + nb, N, rows,
                              min(kHalfN, N - nb));
    cp_async_commit();
    if (threadIdx.x < kTile) {
      cum_r = threadIdx.x < rows ? cumc[k0 + threadIdx.x] : 0.f;
      dt_r = threadIdx.x < rows ? dtc[k0 + threadIdx.x] : 0.f;
    }
  };
  float acc[2][4][4] = {};
  const int n_tiles = (chunk + kTile - 1) / kTile;
  issue(0);
  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();   // tile it - 1 is read: its buffer, wx and ws are free
    if (threadIdx.x < kTile) ws[threadIdx.x] = dt_r * expf(tot - cum_r);
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it and ws are visible to every thread
    const T* xr = xs(it & 1);
    for (int i = threadIdx.x; i < kTile * kMaxP / 4; i += kThreads) {
      const int k = i / (kMaxP / 4), p = i % (kMaxP / 4) * 4;
      const float4 v = load4(xr + k * L::kLdT + p);
      const float w = ws[k];
      *reinterpret_cast<float4*>(wx + k * L::kLdW + p) =
          make_float4(operand<TC>(v.x * w), operand<TC>(v.y * w), operand<TC>(v.z * w),
                      operand<TC>(v.w * w));
    }
    __syncthreads();
    warp_product<TC>(acc, ColsA<L::kLdW>{wx}, ColsB<T, L::kLdT>{bs(it & 1)}, m0, n0, kTile);
  }
  float* out = states + (((size_t)b * H + h) * (nc - 1) + c) * P * N + nb;
  const int n_end = N - nb;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int p = frag_row(m0, i, e);
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_pair(out + (size_t)p * N, frag_col(n0, j, e), n_end, N % 2 == 0, acc[i][j][e],
                   acc[i][j][e + 1]);
    }
}

// 4. states[b, h, c] <- h_{c+1} = exp(tot_c) h_c + S_c, h_0 = 0, in chunk order.
__global__ void __launch_bounds__(kPassThreads)
    ssd_scan_pass_kernel(const float* __restrict__ cum, float* __restrict__ states, int S, int H,
                         int P, int N, int chunk) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= P * N) return;
  const int h = blockIdx.y, b = blockIdx.z, nc = S / chunk;
  const float* cumbh = cum + ((size_t)b * H + h) * S;
  float* st = states + ((size_t)b * H + h) * (nc - 1) * P * N + e;
  float state = 0.f;
  for (int c = 0; c < nc - 1; ++c) {
    const float decay = expf(cumbh[(size_t)c * chunk + chunk - 1]);
    state = decay * state + st[(size_t)c * P * N];
    st[(size_t)c * P * N] = state;
  }
}

// M below the diagonal tile, from C B^T in shared memory as a fragment reads
// it: C B^T exp(cum_q - cum_q0) exp(cum_q0 - cum_k) dt_k, a TF32 operand.
template <bool TC>
struct Decayed {
  const float* cb;   // [q][kLdM]
  const float* eq;   // exp(cum_q - cum_q0)
  const float* ek;   // exp(cum_q0 - cum_k) dt_k
  __device__ __forceinline__ float2 pair(int q, int k) const {
    const float2 c = *reinterpret_cast<const float2*>(cb + q * kLdM + k);
    const float2 e = *reinterpret_cast<const float2*>(ek + k);
    return make_float2(operand<TC>(c.x * eq[q] * e.x), operand<TC>(c.y * eq[q] * e.y));
  }
};

// Shared memory of the output kernel: five vectors of kTile floats, then one
// region that holds first the inter-chunk tiles (C in T, h in fp32) and then
// two buffers of the intra-chunk tiles (C B^T, made M in place, and x in T).
template <typename T>
struct OutLayout {
  static constexpr int kLdC = kMaxN + 8;   // C rows, in T
  static constexpr int kLdXT = kMaxP + 8;                        // x rows, in T
  static constexpr size_t kC = (size_t)kTile * kLdC * sizeof(T);
  static constexpr size_t kH = (size_t)kTile * kLdRow * sizeof(float);
  static constexpr size_t kM = (size_t)kTile * kLdM * sizeof(float);
  static constexpr size_t kBuf = kM + (size_t)kTile * kLdXT * sizeof(T);
  static constexpr size_t kVec = 5 * kTile * sizeof(float);
  static constexpr size_t kBytes = kVec + (kC + kH > 2 * kBuf ? kC + kH : 2 * kBuf);
};

// 5. y for one 64-row q tile of one (b, chunk, h).  Tiles arrive by cp.async
// straight into shared memory, so no registers hold them in flight: the
// inter-chunk tiles in one round trip, then the k tiles double-buffered, the
// loads of tile kt + 1 in flight while the block multiplies tile kt.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    ssd_scan_out_kernel(const T* __restrict__ x, const T* __restrict__ Cc,
                        const float* __restrict__ cum, const float* __restrict__ dtt,
                        const float* __restrict__ cb, const float* __restrict__ states,
                        T* __restrict__ y, int S, int H, int P, int N, int chunk) {
  using L = OutLayout<T>;
  constexpr bool TC = kTC<T>;
  extern __shared__ float4 smem4[];
  float* cq = reinterpret_cast<float*>(smem4);   // [kTile] cum of the q rows
  float* eq = cq + kTile;                         // [kTile] exp(cum_q - cum_q0)
  float* ck = eq + kTile;                         // [kTile] cum of the k rows
  float* dk = ck + kTile;                         // [kTile] dt of the k rows
  float* ek = dk + kTile;                         // [kTile] exp(cum_q0 - cum_k) dt_k
  unsigned char* region = reinterpret_cast<unsigned char*>(smem4) + L::kVec;
  T* cs = reinterpret_cast<T*>(region);                        // C [q][kLdC]
  float* hs = reinterpret_cast<float*>(region + L::kC);        // h [p][kLdRow]
  const auto ms = [region](int buf) { return reinterpret_cast<float*>(region + buf * L::kBuf); };
  const auto xs = [region](int buf) {
    return reinterpret_cast<T*>(region + buf * L::kBuf + L::kM);
  };
  const int h = blockIdx.x, nt = gridDim.y, qt = nt - 1 - blockIdx.y;   // heaviest first
  const int nc = S / chunk, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int q0 = qt * kTile, q_rows = min(kTile, chunk - q0);
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;
  const float* cumc = cum + ((size_t)b * H + h) * S + (size_t)c * chunk;
  const float* dtc = dtt + ((size_t)b * H + h) * S + (size_t)c * chunk;
  const int Qp = nt * kTile;
  const float* cbq = cb + (((size_t)b * nc + c) * Qp + q0) * Qp;
  const int warp = threadIdx.x / 32, m0 = (warp / 2) * 32, n0 = (warp % 2) * 32;
  const float cq0 = cumc[q0];
  if (threadIdx.x < kTile) {
    const bool ok = threadIdx.x < q_rows;
    cq[threadIdx.x] = ok ? cumc[q0 + threadIdx.x] : 0.f;
    eq[threadIdx.x] = ok ? expf(cumc[q0 + threadIdx.x] - cq0) : 0.f;
  }
  float acc[2][4][4] = {};
  if (c > 0) {   // inter-chunk term: exp(cum_q) C_q h_c^T
    async_tile<kTile, kMaxN>(cs, L::kLdC, Cc + (row0 + q0) * N, N, q_rows, N);
    async_tile<kTile, kMaxN>(hs, kLdRow, states + (((size_t)b * H + h) * (nc - 1) + c - 1) * P * N,
                             N, P, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    warp_product<TC>(acc, RowsA<T, L::kLdC>{cs}, RowsB<TC, kLdRow>{hs}, m0, n0, (N + 7) / 8 * 8);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float decay = expf(cq[frag_row(m0, i, e)]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][e] *= decay;
      }
    __syncthreads();   // the region's inter tiles are read
  }
  float cum_r = 0.f, dt_r = 0.f;   // row threadIdx.x of the k tile last issued
  const auto issue = [&](int kt) {
    const int k0 = kt * kTile, k_rows = min(kTile, chunk - k0);
    async_tile<kTile, kTile>(ms(kt & 1), kLdM, cbq + k0, Qp, kTile, kTile);
    async_tile<kTile, kMaxP>(xs(kt & 1), L::kLdXT, x + ((row0 + k0) * H + h) * P, (size_t)H * P,
                             k_rows, P);
    cp_async_commit();
    if (threadIdx.x < kTile) {
      cum_r = threadIdx.x < k_rows ? cumc[k0 + threadIdx.x] : 0.f;
      dt_r = threadIdx.x < k_rows ? dtc[k0 + threadIdx.x] : 0.f;
    }
  };
  issue(0);
  for (int kt = 0; kt <= qt; ++kt) {   // intra-chunk term, k tiles to the diagonal
    const int k_rows = min(kTile, chunk - kt * kTile);
    float* m = ms(kt & 1);
    __syncthreads();   // tile kt - 1 is read: its buffer and the vectors are free
    if (threadIdx.x < kTile) {
      ck[threadIdx.x] = cum_r;
      dk[threadIdx.x] = dt_r;
      // below the diagonal cum_q <= cum_q0 <= cum_k: neither factor passes 1
      ek[threadIdx.x] = kt < qt ? expf(cq0 - cum_r) * dt_r : 0.f;
    }
    if (kt < qt) {
      issue(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile kt and the vectors are visible to every thread
    if (kt < qt) {   // M formed as the fragments are read
      warp_product<TC>(acc, Decayed<TC>{m, eq, ek}, ColsB<T, L::kLdXT>{xs(kt & 1)}, m0, n0, kTile);
      continue;
    }
    // the diagonal tile: M in place over C B^T, an exp per element
    for (int i = threadIdx.x; i < kTile * kTile / 4; i += kThreads) {
      const int r = i / (kTile / 4), k = i % (kTile / 4) * 4;
      float4* p4 = reinterpret_cast<float4*>(m + r * kLdM + k);
      const float4 v = *p4;
      const float vs[4] = {v.x, v.y, v.z, v.w};
      float mv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // select before the exp: above the diagonal cum_q - cum_k > 0
        const bool keep = k + e <= r && r < q_rows && k + e < k_rows;
        mv[e] = keep ? operand<TC>(vs[e] * __expf(cq[r] - ck[k + e]) * dk[k + e]) : 0.f;
      }
      *p4 = make_float4(mv[0], mv[1], mv[2], mv[3]);
    }
    __syncthreads();
    warp_product<TC>(acc, RowsA<float, kLdM>{m}, ColsB<T, L::kLdXT>{xs(kt & 1)}, m0, n0, kTile);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int q = frag_row(m0, i, e);
      if (q >= q_rows) continue;
      T* yrow = y + ((row0 + q0 + q) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_pair(yrow, frag_col(n0, j, e), P, P % 2 == 0, acc[i][j][e], acc[i][j][e + 1]);
    }
}

size_t cb_smem(bool tc) {
  return tc ? 2 * kTile * kLd16 * sizeof(__nv_bfloat16) : 2 * kTile * kLdRow * sizeof(float);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch(const void* xv, const float* dt, const float* A, const void* Bv, const void* Cv,
                   void* yv, float* cum, float* dtt, float* cb, float* states, int B, int S, int H,
                   int P, int N, int chunk, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* Bc = static_cast<const T*>(Bv);
  const T* Cc = static_cast<const T*>(Cv);
  T* y = static_cast<T*>(yv);
  const int nc = S / chunk, nt = (chunk + kTile - 1) / kTile;
  cudaError_t err;
  const long long warps = (long long)B * H * nc;
  ssd_scan_cumsum_kernel<<<(unsigned)((warps + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                           s>>>(dt, A, cum, dtt, B, S, H, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t cbs = cb_smem(kTC<T>);
  if ((err = allow_smem(ssd_scan_cb_kernel<T>, cbs)) != cudaSuccess) return err;
  ssd_scan_cb_kernel<T><<<dim3(nt * (nt + 1) / 2, nc, B), kThreads, cbs, s>>>(Bc, Cc, cb, S, N,
                                                                               chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (nc > 1) {
    const size_t sts = StateLayout<T>::kBytes;
    if ((err = allow_smem(ssd_scan_state_kernel<T>, sts)) != cudaSuccess) return err;
    const int halves = N > kHalfN ? 2 : 1;
    ssd_scan_state_kernel<T><<<dim3(H * halves, nc - 1, B), kThreads, sts, s>>>(
        x, Bc, cum, dtt, states, S, H, P, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_scan_pass_kernel<<<dim3((P * N + kPassThreads - 1) / kPassThreads, H, B), kPassThreads, 0,
                           s>>>(cum, states, S, H, P, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const size_t outs = OutLayout<T>::kBytes;
  if ((err = allow_smem(ssd_scan_out_kernel<T>, outs)) != cudaSuccess) return err;
  ssd_scan_out_kernel<T><<<dim3(H, nt, B * nc), kThreads, outs, s>>>(
      x, Cc, cum, dtt, cb, states, y, S, H, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bc, Cc and y); dt and A are float32.
// Workspaces, fp32, allocated by the caller: cum and dtt [B, H, S], cb
// [B, S / chunk, Qp, Qp] with Qp = chunk rounded up to 64, states
// [B, H, S / chunk - 1, P, N] (unused when S == chunk).
// Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bc,
                            const void* Cc, void* y, void* cum, void* dtt, void* cb, void* states,
                            int B, int S, int H, int P, int N, int chunk, int dtype,
                            void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || chunk < 1 ||
      chunk > kMaxChunk || S % chunk != 0 || H > 65535 || (long long)B * (S / chunk) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* ws[4] = {static_cast<float*>(cum), static_cast<float*>(dtt), static_cast<float*>(cb),
                  static_cast<float*>(states)};
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, dtf, Af, Bc, Cc, y, ws[0], ws[1], ws[2], ws[3], B, S, H, P, N,
                                chunk, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, dtf, Af, Bc, Cc, y, ws[0], ws[1], ws[2], ws[3], B, S,
                                        H, P, N, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
