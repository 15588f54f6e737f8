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
//   at 989 TFLOP/s in bf16.  Longer sequences are bound by operations.
//   chip_smoke.py computes both bounds for each run.
// Design (simple and right first): one block of 256 threads per
//   (batch*head, 64-query tile).  The Q tile, pre-scaled, is held in shared
//   memory as fp32; the block loops over 32-key tiles of K and V, converted to
//   fp32 in shared memory, and keeps an online softmax in fp32.  Four threads
//   share a query row: each computes 8 of the tile's 32 scores and owns hd/4
//   accumulator columns in registers; row max and sum are reduced with warp
//   shuffles.  Rows are padded by one float so the threads of a warp hit
//   distinct banks.  In causal mode key tiles past the query tile's diagonal
//   are skipped.  Query rows and keys past S are masked in the kernel, so there
//   is no padding and no fallback for ragged S.  At hd=256 the tiles take
//   about 137 KB of shared memory, above the 48 KB default, so every launch
//   first raises the dynamic shared-memory limit with cudaFuncSetAttribute;
//   a refused launch is reported by cudaGetLastError.  The products run on the
//   FP32 pipes, not the tensor cores: wgmma/TMA are for a later version.
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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockQ - 1) / kBlockQ));
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      int Hkv, int hd, int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, Hkv, causal, scale, stream);
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
  switch (dtype) {
    case 0: return (int)launch_hd<float>(q, k, v, o, B, S, H, Hkv, hd, causal, scale, s);
    case 1: return (int)launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Message for a cudaError_t returned by any entry point of this library.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
