// Chunked Mamba2 SSD scan for Hopper (sm_90a), bound through a plain C ABI.
//
// Replaces: ssd_scan_pallas / ssd_scan_kernel in
//   src/repro/kernels/ssd_scan/kernel.py (the Pallas TPU kernel).  That kernel
//   carries the fp32 state [Hb, P, N] in VMEM scratch from one grid step to the
//   next, which works because a TPU grid runs in order; a GPU grid does not, so
//   here one block owns one (batch, head) and walks the chunks itself.
// Computes, for x [B,S,H,P] (f32 or bf16), dt [B,S,H] f32 (post-softplus),
//   A [H] f32 (negative) and Bc, Cc [B,S,N] of x's type, chunk by chunk
//   (Q rows each, S % Q == 0), with cum = cumsum(dt * A) inside the chunk and
//   the state h [P,N] fp32 as it stood at the chunk's start (zero at first):
//     y[q]  = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//           + exp(cum_q) C_q h^T
//     h    <- exp(tot) h + sum_k dt_k exp(tot - cum_k) x_k (x) B_k,  tot = cum_{Q-1}
//   y is written in x's type; the final state is not returned.  All arithmetic
//   is fp32.
// Bound: at the serving path's shapes (B=4, S=1024, H=48, P=64, N=128, Q=256,
//   bf16) bytes: x read and y written (25 MB each), dt, B and C read (3 MB)
//   are about 53 MB, 16 us at 3.35 TB/s, against about 10 us for the 9.8 GFLOP
//   of the products (C.B^T once per chunk, the causal half) at 989 TFLOP/s in
//   bf16.  chip_smoke.py computes both bounds for each run.
// Design (simple and right first): one block of 256 threads per (b, h), 192
//   blocks at the path's shape.  Each chunk is cut into 64-row tiles of q and
//   k, so no Q x Q or Q x N tile has to fit whole and any Q (1 .. 4096) works;
//   rows past Q are zero in the tiles and masked.  Per chunk: a warp scan
//   builds cum; for each q tile the inter-chunk term C h^T is taken from the
//   state in shared memory, then for each k tile on or below the diagonal the
//   block forms M = (C B^T) exp(cum_q - cum_k) dt_k, selecting 0 above the
//   diagonal before any exp can overflow, and adds M x.  A last pass over the
//   k tiles accumulates the state update in registers.  Every product is a
//   16 x 16 grid of threads, each owning a 4 x 4 (state: 8 x 4) register tile
//   fed by 16-byte shared-memory loads; rows are padded to 4 mod 32 floats so
//   the loads of a warp do not collide in a bank.  P <= 64 and N <= 128 are
//   zero-padded to those sizes.  The tiles take about 137 KB of shared memory
//   (plus 12 bytes a chunk row), above the 48 KB default, so every launch
//   first raises the limit with cudaFuncSetAttribute, and cudaGetLastError
//   reports a refused launch.  The products run on the FP32 pipes and C B^T is
//   formed once per head, not once per chunk: tensor cores, a shared C B^T
//   and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kTile = 64;            // q and k rows per tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 4096;
constexpr int kLdN = kMaxN + 4;      // padded row lengths, 4 mod 32 floats
constexpr int kLdP = kMaxP + 4;
constexpr int kLdK = kTile + 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

size_t smem_bytes(int chunk_pad) {
  const size_t floats = (size_t)kTile * kLdN * 2      // C tile, B tile
                        + (size_t)kTile * kLdP        // x tile
                        + (size_t)kTile * kLdK        // M tile
                        + (size_t)kMaxN * kLdP        // state, [n][p]
                        + (size_t)chunk_pad * 3;      // dt, cum, state weights
  return floats * sizeof(float);
}

// dst[r][c] = src row r, column c for r < rows, c < cols; zero elsewhere in
// the kTile x COLS tile.  Rows of src are row_stride elements apart.  With a
// row_scale, row r is multiplied by row_scale[r].
template <int COLS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, size_t row_stride,
                                          int rows, int cols, const float* row_scale) {
  for (int idx = threadIdx.x; idx < kTile * COLS; idx += kThreads) {
    const int r = idx / COLS, c = idx % COLS;
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_float(src[(size_t)r * row_stride + c]);
      if (row_scale) v *= row_scale[r];
    }
    dst[r * ld + c] = v;
  }
}

// acc[i][j] += sum_t a[tr + 16i][t] * b[tc + 16j][t]: both operands hold the
// contraction along their rows.
__device__ __forceinline__ void product_nt(float (&acc)[4][4], const float* a, int lda,
                                           const float* b, int ldb, int len, int tr, int tc) {
  for (int t = 0; t < len; t += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (tr + 16 * i) * lda + t);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(b + (tc + 16 * j) * ldb + t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] += sum_t a[tr + 16i][t] * b[t][4tc + j]: a holds the contraction
// along its rows, b down its columns.
__device__ __forceinline__ void product_nn(float (&acc)[4][4], const float* a, int lda,
                                           const float* b, int ldb, int len, int tr, int tc) {
  for (int t = 0; t < len; t += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (tr + 16 * i) * lda + t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 bv = ld4(b + (t + c) * ldb + 4 * tc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a_ic = comp(av[i], c);
        acc[i][0] = fmaf(a_ic, bv.x, acc[i][0]);
        acc[i][1] = fmaf(a_ic, bv.y, acc[i][1]);
        acc[i][2] = fmaf(a_ic, bv.z, acc[i][2]);
        acc[i][3] = fmaf(a_ic, bv.w, acc[i][3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bc,
                    const T* __restrict__ Cc, T* __restrict__ y, int S, int H, int P, int N,
                    int chunk) {
  extern __shared__ float4 smem4[];
  const int chunk_pad = (chunk + kTile - 1) / kTile * kTile;
  float* cs = reinterpret_cast<float*>(smem4);   // C tile  [kTile][kLdN]
  float* bs = cs + kTile * kLdN;                 // B tile  [kTile][kLdN]
  float* xs = bs + kTile * kLdN;                 // x tile  [kTile][kLdP]
  float* ms = xs + kTile * kLdP;                 // M tile  [kTile(q)][kLdK]
  float* hs = ms + kTile * kLdK;                 // state   [kMaxN][kLdP], h^T
  float* dts = hs + kMaxN * kLdP;                // [chunk_pad]
  float* cum = dts + chunk_pad;                  // [chunk_pad]
  float* wts = cum + chunk_pad;                  // [chunk_pad] dt_k exp(tot - cum_k)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const float a_h = A[h];
  const size_t x_row = (size_t)H * P;            // elements between rows of x and y
  const T* xb = x + (size_t)b * S * x_row + (size_t)h * P;
  T* yb = y + (size_t)b * S * x_row + (size_t)h * P;
  const T* bb = Bc + (size_t)b * S * N;
  const T* cb = Cc + (size_t)b * S * N;
  const float* dtb = dt + (size_t)b * S * H + h;
  const int n_tiles = chunk_pad / kTile;

  for (int i = tid; i < kMaxN * kLdP; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk's reads of dts, cum and wts are done
    for (int r = tid; r < chunk_pad; r += kThreads)
      dts[r] = r < chunk ? dtb[(size_t)(c0 + r) * H] : 0.f;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of dt * A; rows past the chunk keep tot
      float carry = 0.f;
      for (int r0 = 0; r0 < chunk_pad; r0 += 32) {
        float v = dts[r0 + lane] * a_h;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        cum[r0 + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float tot = cum[chunk - 1];
    for (int r = tid; r < chunk_pad; r += kThreads)
      wts[r] = r < chunk ? dts[r] * expf(tot - cum[r]) : 0.f;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      const int q_rows = min(kTile, chunk - q0);
      __syncthreads();  // the previous tile's reads of cs are done
      load_tile<kMaxN>(cs, kLdN, cb + (size_t)(c0 + q0) * N, N, q_rows, N, nullptr);
      __syncthreads();
      // inter-chunk term: exp(cum_q) * C_q h^T
      float acc[4][4] = {};
      product_nn(acc, cs, kLdN, hs, kLdP, kMaxN, tr, tc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float decay = expf(cum[q0 + tr + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
      }
      // intra-chunk term over the k tiles on or below the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        __syncthreads();  // the previous k tile's reads of bs, xs and ms are done
        load_tile<kMaxN>(bs, kLdN, bb + (size_t)(c0 + k0) * N, N, min(kTile, chunk - k0), N,
                         nullptr);
        load_tile<kMaxP>(xs, kLdP, xb + (size_t)(c0 + k0) * x_row, x_row,
                         min(kTile, chunk - k0), P, nullptr);
        __syncthreads();
        float cbt[4][4] = {};
        product_nt(cbt, cs, kLdN, bs, kLdN, kMaxN, tr, tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + tr + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tc + 16 * j;
            // select before the exp: above the diagonal cum_q - cum_k > 0
            const float m = k <= q ? cbt[i][j] * expf(cum[q] - cum[k]) * dts[k] : 0.f;
            ms[(tr + 16 * i) * kLdK + tc + 16 * j] = m;
          }
        }
        __syncthreads();
        product_nn(acc, ms, kLdK, xs, kLdP, kTile, tr, tc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + tr + 16 * i;
        if (q >= chunk) continue;
        T* yrow = yb + (size_t)(c0 + q) * x_row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * tc + j;
          if (p < P) from_float(acc[i][j], yrow + p);
        }
      }
    }

    // state update: h^T[n][p] <- exp(tot) h^T[n][p] + sum_k B[k][n] w_k x[k][p]
    float dh[8][4] = {};
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kTile;
      __syncthreads();  // the previous reads of bs and xs are done
      load_tile<kMaxN>(bs, kLdN, bb + (size_t)(c0 + k0) * N, N, min(kTile, chunk - k0), N,
                       nullptr);
      load_tile<kMaxP>(xs, kLdP, xb + (size_t)(c0 + k0) * x_row, x_row,
                       min(kTile, chunk - k0), P, wts + k0);
      __syncthreads();
      for (int k = 0; k < kTile; ++k) {
        const float4 b0 = ld4(bs + k * kLdN + 8 * tr);
        const float4 b1 = ld4(bs + k * kLdN + 8 * tr + 4);
        const float4 xv = ld4(xs + k * kLdP + 4 * tc);
        const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          dh[r][0] = fmaf(bn[r], xv.x, dh[r][0]);
          dh[r][1] = fmaf(bn[r], xv.y, dh[r][1]);
          dh[r][2] = fmaf(bn[r], xv.z, dh[r][2]);
          dh[r][3] = fmaf(bn[r], xv.w, dh[r][3]);
        }
      }
    }
    // Every read of hs in this chunk came before the syncs above, and each
    // thread now writes only its own elements.
    const float decay = expf(tot);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* row = hs + (8 * tr + r) * kLdP + 4 * tc;
#pragma unroll
      for (int j = 0; j < 4; ++j) row[j] = row[j] * decay + dh[r][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bc, const void* Cc,
                   void* y, int B, int S, int H, int P, int N, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes((chunk + kTile - 1) / kTile * kTile);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<(unsigned)(B * H), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<T*>(y), S, H, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bc, Cc and y); dt and A are float32.
// Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bc,
                            const void* Cc, void* y, int B, int S, int H, int P, int N, int chunk,
                            int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || chunk < 1 ||
      chunk > kMaxChunk || S % chunk != 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  switch (dtype) {
    case 0: return (int)launch<float>(x, dtf, Af, Bc, Cc, y, B, S, H, P, N, chunk, s);
    case 1: return (int)launch<__nv_bfloat16>(x, dtf, Af, Bc, Cc, y, B, S, H, P, N, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
