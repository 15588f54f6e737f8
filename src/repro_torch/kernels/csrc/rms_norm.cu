// Row RMSNorm for Hopper (sm_90a), bound through a plain C ABI.
//
// Replaces: rms_norm_pallas / rms_norm_kernel in
//   src/repro/kernels/rms_norm/kernel.py (the Pallas TPU kernel), which tiles
//   128 padded rows at a time through VMEM.
// Computes: out = x * rsqrt(mean(x^2) + eps) * (1 + scale), the mean of
//   squares in fp32, cast back to the input type (f32 or bf16).
// Bound: bytes.  The row is read once and written once and the gain is read
//   once per row from L2, so the least time is
//   (2 * rows * D * itemsize + D * itemsize) / 3.35 TB/s.  There are a few
//   operations per byte, far below the card's ~295 operations per byte.
// Design: one block per row, so any row count runs without padding.  Each
//   thread loads its share of the row as 16-byte vectors into registers,
//   sums the squares in fp32, reduces with warp shuffles and one
//   shared-memory step, then scales the vectors it still holds and stores
//   them: one read and one write of the row.  The block has as many threads
//   as the row has vectors, rounded up to a warp, and at most 256; the
//   vectors per thread (1 to 16, which covers D = 16384 in f32) are a
//   template parameter chosen per launch, so a short row keeps few registers
//   and many blocks fit on an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxVecPerThread = 16;  // 16 x 16 B x 256 threads = 64 KiB rows

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;  // elements per 16-byte vector
  __device__ static void load(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 store(const float (&f)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ out, int D, float eps) {
  constexpr int N = Pack<T>::N;
  const int n_vec = D / N;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  uint4* outr = reinterpret_cast<uint4*>(out + row * D);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);

  uint4 v[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < n_vec) {
      v[i] = xr[idx];
      float f[N];
      Pack<T>::load(v[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float inv_rms;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < blockDim.x / 32; ++w) total += warp_sums[w];
    inv_rms = rsqrtf(total / D + eps);
  }
  __syncthreads();
  const float r = inv_rms;

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < n_vec) {
      float f[N], g[N];
      Pack<T>::load(v[i], f);
      Pack<T>::load(sr[idx], g);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = f[j] * r * (1.f + g[j]);
      outr[idx] = Pack<T>::store(f);
    }
  }
}

template <typename T, int VPT>
void launch_vpt(const void* x, const void* scale, void* out, long long rows, int D,
                float eps, int threads, cudaStream_t stream) {
  rms_norm_kernel<T, VPT><<<dim3((unsigned)rows), dim3(threads), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), D, eps);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows,
                   int D, float eps, cudaStream_t stream) {
  const int n_vec = D / Pack<T>::N;
  if (n_vec < 1 || n_vec > kMaxThreads * kMaxVecPerThread) return cudaErrorInvalidValue;
  int threads = ((n_vec + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int need = (n_vec + threads - 1) / threads;  // vectors per thread
  if (need <= 1) launch_vpt<T, 1>(x, scale, out, rows, D, eps, threads, stream);
  else if (need <= 2) launch_vpt<T, 2>(x, scale, out, rows, D, eps, threads, stream);
  else if (need <= 4) launch_vpt<T, 4>(x, scale, out, rows, D, eps, threads, stream);
  else if (need <= 8) launch_vpt<T, 8>(x, scale, out, rows, D, eps, threads, stream);
  else launch_vpt<T, 16>(x, scale, out, rows, D, eps, threads, stream);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int rms_norm_fwd(const void* x, const void* scale, void* out, long long rows,
                            int D, float eps, int dtype, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, scale, out, rows, D, eps, s);
    case 1: return (int)launch<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
