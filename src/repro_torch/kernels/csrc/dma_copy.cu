// Tiled device-to-device copy for Hopper (sm_90a), two ways, bound through a
// plain C ABI.
//
// Replaces: dma_copy_pipelined and dma_copy_explicit in
//   src/repro/kernels/dma_copy/kernel.py (the Pallas TPU kernels of the
//   paper's controlled-DMA case study).  Both copy an [R, C] array in tiles of
//   block_rows rows, one grid step per tile; here one block per tile
//   (explicit) or per slice of a tile (pipelined).
// Computes: dst = src, byte for byte, for any element type: the interface
//   takes rows, columns and the element size, and the kernels move
//   tile_bytes = block_rows * C * elem_size bytes at byte offset
//   tile * tile_bytes.
// Bound: bytes.  Every byte is read once and written once, 2 * R * C *
//   elem_size bytes over 3.35 TB/s (0.1603 ms for the 256 MiB bf16 array
//   chip_smoke.py copies); there is no arithmetic.
// Design:
//   pipelined — the "automatic" path.  Each of 256 threads keeps four 16-byte
//     loads in flight before it stores them, so the hardware overlaps the
//     loads of a block as BlockSpec double-buffering overlaps the TPU's DMAs.
//     Streaming cache hints (__ldcs/__stcs) keep the once-used bytes from
//     evicting others in L2.  The grid does not follow the tiles: each tile
//     is cut into slices of slice_bytes (a multiple of 16; the caller picks
//     16 KiB, one pass of the block's four loads a thread), one block a slice,
//     the last slice of a tile shorter.  Block i copies slice i % slices of
//     tile i / slices, so blocks in index order sweep neighbouring addresses
//     and the grid holds thousands of blocks at any block_rows, as copy_'s
//     does, where one block a tile would leave SMs idle (128 blocks of 2 MiB
//     at block_rows 256 on 132 SMs).  A slice begins on a 16-byte boundary
//     wherever its tile does; where the tile does not (rows whose bytes are
//     not a multiple of 16), the slice's head and tail of at most 15 bytes go
//     by bytes and the rest still by vectors, since a tile's offset is the
//     same in src and dst.
//   explicit — the paper's controlled DMA issuance: one elected thread writes
//     the copy descriptors itself.  The tile goes in pieces of at most 32 KiB
//     through a ring of 4 stages of dynamic shared memory (128 KiB), each
//     stage with its own mbarrier and parity bit.  The thread first issues
//     the bulk (TMA) loads global->shared of up to 4 pieces (copy_in.start,
//     each completing on its stage's barrier).  Then for each piece i in
//     order: it waits for piece i on its barrier (copy_in.wait), issues its
//     store shared->global as one bulk group (copy_out.start), and refills
//     the stage of piece i-1 with piece i+3 once that stage's store has read
//     the buffer (cp.async.bulk.wait_group.read 1: only the store just
//     issued may still be reading; no store's write is waited for).  So up
//     to three loads are in flight beside one or two stores, and a block
//     reads while it writes, where the first version ran load, wait, store,
//     wait for the write, one 64 KiB piece at a time.  The thread waits for
//     every write once, at the end of the tile (copy_out.wait).  A tile of
//     fewer pieces than stages takes only the stages it needs (2 at
//     block_rows 8 and C 4096 in bf16: 64 KiB, three blocks an SM as
//     before).  Each launch raises the block's dynamic shared-memory limit
//     first and reports a refused launch through cudaGetLastError.  On an
//     H100 the ring leaves the time at block_rows 256 where the single piece
//     had it, behind copy_ (PERF.md): the depth in flight was not what held
//     it back.
//   Bulk copies need 16-byte-aligned addresses and sizes.  A tile whose
//   offset or size is not a multiple of 16 (int8 with an odd C, say) moves
//   its unaligned head and tail with the block's threads, and a tile whose
//   source and destination are misaligned against each other moves whole
//   with them; the pipelined kernel does the same around its vectors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPipelinedThreads = 256;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int kExplicitThreads = 128;      // byte heads and tails only
constexpr unsigned kPiece = 32 * 1024;     // bytes a bulk copy moves at most
constexpr unsigned kStages = 4;            // pieces of the explicit kernel's ring

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
                              size_t tile_bytes, size_t slice_bytes, unsigned slices) {
  const size_t begin = (size_t)(blockIdx.x % slices) * slice_bytes;
  const size_t off = (size_t)(blockIdx.x / slices) * tile_bytes + begin;
  const size_t bytes = tile_bytes - begin < slice_bytes ? tile_bytes - begin : slice_bytes;
  const unsigned char* s = src + off;
  unsigned char* d = dst + off;
  if (!co_aligned(s, d)) {
    copy_bytes(s, d, 0, bytes);
    return;
  }
  const size_t head = head_bytes(s, bytes);
  const size_t nv = (bytes - head) / 16;
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
  copy_bytes(s, d, head + nv * 16, bytes);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t buf, const unsigned char* g, uint32_t bytes,
                                          uint32_t bar) {
  // copy_in.start(): expect `bytes` on the stage's barrier, then issue the load
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(buf),
      "l"(g), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint32_t bar, uint32_t parity) {
  // copy_in.wait(): the barrier's phase flips once all bytes have landed
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ready)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__global__ void __launch_bounds__(kExplicitThreads)
    dma_copy_explicit_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                             size_t tile_bytes, unsigned piece) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar[kStages];
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

  const size_t n = (body + piece - 1) / piece;            // pieces of this tile
  const unsigned stages = n < kStages ? (unsigned)n : kStages;
  const uint32_t buf_a = smem_addr(buf), bar_a = smem_addr(bar);
  for (unsigned st = 0; st < stages; ++st)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_a + 8 * st), "r"(1u)
                 : "memory");
  // make the initialised barriers visible to the async (TMA) proxy
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const unsigned char* gs = s + head;
  unsigned char* gd = d + head;
  auto bytes_of = [&](size_t i) {
    return (uint32_t)(body - i * piece < piece ? body - i * piece : piece);
  };
  for (unsigned st = 0; st < stages; ++st)
    bulk_load(buf_a + st * piece, gs + st * piece, bytes_of(st), bar_a + 8 * st);
  uint32_t phase = 0;   // bit st: parity of stage st's next completion
  for (size_t i = 0; i < n; ++i) {
    const unsigned st = (unsigned)(i % stages);
    bulk_wait(bar_a + 8 * st, (phase >> st) & 1u);
    phase ^= 1u << st;
    // copy_out.start(): the piece's store, one bulk group
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                     gd + i * piece),
                 "r"(buf_a + st * piece), "r"(bytes_of(i))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // refill the previous piece's stage with the piece `stages` after it,
    // once that stage's store has read it (the newest group may still read)
    const size_t j = i + stages - 1;
    if (i >= 1 && j < n) {
      const unsigned pst = (unsigned)((i - 1) % stages);
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      bulk_load(buf_a + pst * piece, gs + j * piece, bytes_of(j), bar_a + 8 * pst);
    }
  }
  // copy_out.wait(): every write of the tile has completed
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

bool valid(long long rows, long long cols, int elem_size, int block_rows) {
  return rows > 0 && cols > 0 && elem_size > 0 && block_rows > 0 && rows % block_rows == 0 &&
         rows / block_rows <= 0x7fffffffLL;
}

// Slices a tile of the pipelined copy, or 0 if the split is not valid or
// the grid would pass 2^31 - 1 blocks.
long long pipelined_slices(long long rows, long long cols, int elem_size, int block_rows,
                           long long slice_bytes) {
  if (!valid(rows, cols, elem_size, block_rows) || slice_bytes <= 0 || slice_bytes % 16 != 0)
    return 0;
  const long long tile_bytes = (long long)block_rows * cols * elem_size;
  const long long slices = (tile_bytes + slice_bytes - 1) / slice_bytes;
  return slices <= 0x7fffffffLL / (rows / block_rows) ? slices : 0;
}

}  // namespace

// Both entry points copy rows x cols elements of elem_size bytes from src to
// dst (contiguous, not overlapping) in tiles of block_rows rows, on the given
// stream: the pipelined copy one block per slice of slice_bytes of a tile, the
// explicit copy one block per tile.  Each returns a cudaError_t (0 on success).
extern "C" int dma_copy_pipelined(const void* src, void* dst, long long rows, long long cols,
                                  int elem_size, int block_rows, long long slice_bytes,
                                  void* stream) {
  const long long slices = pipelined_slices(rows, cols, elem_size, block_rows, slice_bytes);
  if (slices == 0) return (int)cudaErrorInvalidValue;
  const size_t tile_bytes = (size_t)block_rows * (size_t)cols * (size_t)elem_size;
  dma_copy_pipelined_kernel<<<(unsigned)(rows / block_rows * slices), kPipelinedThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), tile_bytes,
      (size_t)slice_bytes, (unsigned)slices);
  return (int)cudaGetLastError();
}

extern "C" int dma_copy_explicit(const void* src, void* dst, long long rows, long long cols,
                                 int elem_size, int block_rows, void* stream) {
  if (!valid(rows, cols, elem_size, block_rows)) return (int)cudaErrorInvalidValue;
  const size_t tile_bytes = (size_t)block_rows * (size_t)cols * (size_t)elem_size;
  // the ring holds up to kStages pieces of the tile rounded up to 16 bytes
  const size_t rounded = (tile_bytes + 15) & ~(size_t)15;
  const unsigned piece = (unsigned)(rounded < kPiece ? rounded : kPiece);
  const size_t pieces = (rounded + piece - 1) / piece;
  const int smem = (int)(piece * (pieces < kStages ? pieces : kStages));
  cudaError_t err = cudaFuncSetAttribute(dma_copy_explicit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dma_copy_explicit_kernel<<<(unsigned)(rows / block_rows), kExplicitThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), tile_bytes, piece);
  return (int)cudaGetLastError();
}

// The launch of mode 0 (pipelined, slices of slice_bytes) or 1 (explicit,
// its ring's shared memory as dma_copy_explicit sizes it): the blocks of its
// grid and the blocks of it one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a cudaError_t.
extern "C" int dma_copy_occupancy(int mode, long long rows, long long cols, int elem_size,
                                  int block_rows, long long slice_bytes, long long* grid,
                                  int* blocks_per_sm) {
  if (mode == 0) {
    const long long slices = pipelined_slices(rows, cols, elem_size, block_rows, slice_bytes);
    if (slices == 0) return (int)cudaErrorInvalidValue;
    *grid = rows / block_rows * slices;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, dma_copy_pipelined_kernel, kPipelinedThreads, 0);
  }
  if (mode != 1 || !valid(rows, cols, elem_size, block_rows)) return (int)cudaErrorInvalidValue;
  const size_t tile_bytes = (size_t)block_rows * (size_t)cols * (size_t)elem_size;
  const size_t rounded = (tile_bytes + 15) & ~(size_t)15;
  const unsigned piece = (unsigned)(rounded < kPiece ? rounded : kPiece);
  const size_t pieces = (rounded + piece - 1) / piece;
  const size_t smem = piece * (pieces < kStages ? pieces : kStages);
  cudaError_t err = cudaFuncSetAttribute(dma_copy_explicit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  *grid = rows / block_rows;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, dma_copy_explicit_kernel, kExplicitThreads, smem);
}
