// Inline host->device transfer for Hopper (sm_90a): the payload rides in the
// kernel launch itself, bound through a plain C ABI.
//
// Counterpart of: the inline protocol of src/repro/core/dma.py (inline_put),
//   which bakes the payload into a compiled executable as a constant and
//   dispatches it to materialize the payload on the device.  The paper's
//   inline DMA (section 6.2) carries the bytes inside the command stream and
//   has the compute engine write them out.  Here the bytes go in the kernel's
//   parameter block, which the driver writes into the launch command itself,
//   and the kernel stores them at the destination: no cudaMemcpy, no copy
//   engine.
// Limits: CUDA 12.1 and later take up to 32,764 bytes of kernel parameters on
//   sm_70 and later.  The payload block (a multiple of 16 bytes, 16-byte
//   aligned) plus the destination pointer and the byte count must fit, so a
//   launch carries at most 32,752 bytes; a larger payload is split across
//   launches.  The blocks come in four sizes so that a small payload does not
//   pay for a 32 KiB launch.  A refused launch is reported through
//   cudaGetLastError and raised by the caller.
// Bound: the launch command's bytes; the device work is one store per
//   payload byte.  One block of 256 threads per launch reads the parameter
//   block 16 bytes a thread (__grid_constant__ keeps it in parameter space
//   instead of copying it to each thread).
// The caller (repro_torch/core/dma.py) captures the launches of one payload
//   into a CUDA graph once; a put is then one graph replay.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxPiece = 32752;     // 32,764 - 8 (pointer) - 4 (count)

template <int N>
struct alignas(16) Payload {
  unsigned char b[N];
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    inline_put_kernel(const __grid_constant__ Payload<N> p, unsigned char* dst, int nbytes) {
  const int nv = nbytes / 16;
  const int4* pv = reinterpret_cast<const int4*>(p.b);
  // dst is 16-byte aligned: the wrapper allocates it, and pieces start at
  // multiples of kMaxPiece (a multiple of 16)
  int4* dv = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) dv[i] = pv[i];
  for (int i = nv * 16 + threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = p.b[i];
}

template <int N>
cudaError_t launch_piece(const unsigned char* src, int n, unsigned char* dst, cudaStream_t s) {
  static Payload<N> p;                       // 32 KiB is too much for a stack
  memcpy(p.b, src, n);
  memset(p.b + n, 0, N - n);
  inline_put_kernel<N><<<1, kThreads, 0, s>>>(p, dst, n);
  return cudaGetLastError();
}

template <int N>
cudaError_t load_kernel() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, inline_put_kernel<N>);
}

}  // namespace

// Loads the kernels' module.  Call before capturing inline_put_launch into a
// graph: a module must not be loaded lazily during a capture.
extern "C" int inline_put_prepare() {
  cudaError_t err;
  if ((err = load_kernel<256>()) != cudaSuccess) return (int)err;
  if ((err = load_kernel<2048>()) != cudaSuccess) return (int)err;
  if ((err = load_kernel<8192>()) != cudaSuccess) return (int)err;
  return (int)load_kernel<(int)kMaxPiece>();
}

// Writes nbytes of host memory at payload to device memory at dst (16-byte
// aligned) on the given stream, carried in the parameters of
// ceil(nbytes / 32752) launches.  Returns a cudaError_t (0 on success).  Not
// thread-safe: the parameter block is staged in static host memory.
extern "C" int inline_put_launch(const void* payload, long long nbytes, void* dst, void* stream) {
  if (nbytes < 0 || (reinterpret_cast<uintptr_t>(dst) & 15)) return (int)cudaErrorInvalidValue;
  const unsigned char* src = static_cast<const unsigned char*>(payload);
  unsigned char* out = static_cast<unsigned char*>(dst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long off = 0; off < nbytes; off += kMaxPiece) {
    const int n = (int)(nbytes - off < kMaxPiece ? nbytes - off : kMaxPiece);
    cudaError_t err;
    if (n <= 256) err = launch_piece<256>(src + off, n, out + off, s);
    else if (n <= 2048) err = launch_piece<2048>(src + off, n, out + off, s);
    else if (n <= 8192) err = launch_piece<8192>(src + off, n, out + off, s);
    else err = launch_piece<(int)kMaxPiece>(src + off, n, out + off, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
