// Tiled device-to-device copy for Hopper (sm_90a), two ways, bound through a
// plain C ABI.
//
// Replaces: dma_copy_pipelined and dma_copy_explicit in
//   src/repro/kernels/dma_copy/kernel.py (the Pallas TPU kernels of the
//   paper's controlled-DMA case study).  Both copy an [R, C] array in tiles of
//   block_rows rows, one grid step per tile; here one block per tile.
// Computes: dst = src, byte for byte, for any element type: the interface
//   takes rows, columns and the element size, and the kernels move
//   tile_bytes = block_rows * C * elem_size bytes at byte offset
//   tile * tile_bytes.
// Bound: bytes.  Every byte is read once and written once, 2 * R * C *
//   elem_size bytes over 3.35 TB/s (0.1603 ms for the 256 MiB bf16 array
//   chip_smoke.py copies); there is no arithmetic.
// Design:
//   pipelined — the "automatic" path.  Each of 512 threads keeps four 16-byte
//     loads in flight before it stores them, so the hardware overlaps the
//     loads of a block as BlockSpec double-buffering overlaps the TPU's DMAs.
//     Streaming cache hints (__ldcs/__stcs) keep the once-used bytes from
//     evicting others in L2.
//   explicit — the paper's controlled DMA issuance: one elected thread writes
//     the copy descriptors itself.  For each piece of at most 64 KiB of the
//     tile it issues a bulk (TMA) copy global->shared completed on an mbarrier
//     (copy_in.start/wait), then a bulk copy shared->global in a bulk group
//     and waits for the group (copy_out.start/wait), in the reference's order:
//     right first, not fast.  A tile larger than shared memory (2 MiB at
//     block_rows 256 and C 4096 in bf16) goes in pieces, so one block needs
//     64 KiB of dynamic shared memory at most; each launch raises the block's
//     limit first and reports a refused launch through cudaGetLastError.
//   Bulk copies need 16-byte-aligned addresses and sizes.  A tile whose
//   offset or size is not a multiple of 16 (int8 with an odd C, say) moves
//   its unaligned head and tail with the block's threads, and a tile whose
//   source and destination are misaligned against each other moves whole
//   with them; the pipelined kernel does the same around its vectors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPipelinedThreads = 512;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int kExplicitThreads = 128;      // byte heads and tails only
constexpr unsigned kPiece = 64 * 1024;     // bytes a bulk copy moves at most

__device__ __forceinline__ bool co_aligned(const unsigned char* s, const unsigned char* d) {
  return ((reinterpret_cast<uintptr_t>(s) ^ reinterpret_cast<uintptr_t>(d)) & 15) == 0;
}

__device__ __forceinline__ size_t head_bytes(const unsigned char* s, size_t n) {
  const size_t h = (16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15;
  return h < n ? h : n;
}

__device__ __forceinline__ void copy_bytes(const unsigned char* s, unsigned char* d, size_t begin,
                                           size_t end) {
  for (size_t i = begin + threadIdx.x; i < end; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(kPipelinedThreads)
    dma_copy_pipelined_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                              size_t tile_bytes) {
  const size_t off = (size_t)blockIdx.x * tile_bytes;
  const unsigned char* s = src + off;
  unsigned char* d = dst + off;
  if (!co_aligned(s, d)) {
    copy_bytes(s, d, 0, tile_bytes);
    return;
  }
  const size_t head = head_bytes(s, tile_bytes);
  const size_t nv = (tile_bytes - head) / 16;
  copy_bytes(s, d, 0, head);
  const int4* sv = reinterpret_cast<const int4*>(s + head);
  int4* dv = reinterpret_cast<int4*>(d + head);
  const size_t stride = (size_t)kUnroll * blockDim.x;
  for (size_t base = threadIdx.x; base < nv; base += stride) {
    int4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)u * blockDim.x;
      r[u] = i < nv ? __ldcs(sv + i) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)u * blockDim.x;
      if (i < nv) __stcs(dv + i, r[u]);
    }
  }
  copy_bytes(s, d, head + nv * 16, tile_bytes);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kExplicitThreads)
    dma_copy_explicit_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                             size_t tile_bytes, unsigned piece) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  const size_t off = (size_t)blockIdx.x * tile_bytes;
  const unsigned char* s = src + off;
  unsigned char* d = dst + off;
  // [head, head + body) is 16-byte aligned on both sides and goes by TMA;
  // the bytes around it go by the block's threads, at the same time.
  const bool aligned = co_aligned(s, d);
  const size_t head = aligned ? head_bytes(s, tile_bytes) : tile_bytes;
  const size_t body = aligned ? (tile_bytes - head) & ~(size_t)15 : 0;
  copy_bytes(s, d, 0, head);
  copy_bytes(s, d, head + body, tile_bytes);
  if (body == 0 || threadIdx.x != 0) return;

  const uint32_t bar_a = smem_addr(&bar), buf_a = smem_addr(buf);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_a), "r"(1u) : "memory");
  // make the initialised barrier visible to the async (TMA) proxy
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  uint32_t phase = 0;
  for (size_t done = 0; done < body; done += piece) {
    const uint32_t bytes = (uint32_t)(body - done < piece ? body - done : piece);
    const unsigned char* gs = s + head + done;
    unsigned char* gd = d + head + done;
    // copy_in.start(): expect `bytes` on the barrier, then issue the load
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(buf_a),
        "l"(gs), "r"(bytes), "r"(bar_a)
        : "memory");
    // copy_in.wait(): the barrier's phase flips once all bytes have landed
    uint32_t ready = 0;
    while (!ready) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(ready)
          : "r"(bar_a), "r"(phase)
          : "memory");
    }
    phase ^= 1;
    // copy_out.start() and copy_out.wait(): the store completes before the
    // buffer is loaded again
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(gd),
                 "r"(buf_a), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

bool valid(long long rows, long long cols, int elem_size, int block_rows) {
  return rows > 0 && cols > 0 && elem_size > 0 && block_rows > 0 && rows % block_rows == 0 &&
         rows / block_rows <= 0x7fffffffLL;
}

}  // namespace

// Both entry points copy rows x cols elements of elem_size bytes from src to
// dst (contiguous, not overlapping), one block per tile of block_rows rows,
// on the given stream.  Each returns a cudaError_t (0 on success).
extern "C" int dma_copy_pipelined(const void* src, void* dst, long long rows, long long cols,
                                  int elem_size, int block_rows, void* stream) {
  if (!valid(rows, cols, elem_size, block_rows)) return (int)cudaErrorInvalidValue;
  const size_t tile_bytes = (size_t)block_rows * (size_t)cols * (size_t)elem_size;
  dma_copy_pipelined_kernel<<<(unsigned)(rows / block_rows), kPipelinedThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), tile_bytes);
  return (int)cudaGetLastError();
}

extern "C" int dma_copy_explicit(const void* src, void* dst, long long rows, long long cols,
                                 int elem_size, int block_rows, void* stream) {
  if (!valid(rows, cols, elem_size, block_rows)) return (int)cudaErrorInvalidValue;
  const size_t tile_bytes = (size_t)block_rows * (size_t)cols * (size_t)elem_size;
  // the buffer holds one piece: the tile rounded up to 16 bytes, at most kPiece
  const size_t rounded = (tile_bytes + 15) & ~(size_t)15;
  const unsigned piece = (unsigned)(rounded < kPiece ? rounded : kPiece);
  cudaError_t err = cudaFuncSetAttribute(dma_copy_explicit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)piece);
  if (err != cudaSuccess) return (int)err;
  dma_copy_explicit_kernel<<<(unsigned)(rows / block_rows), kExplicitThreads, piece,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), tile_bytes, piece);
  return (int)cudaGetLastError();
}
