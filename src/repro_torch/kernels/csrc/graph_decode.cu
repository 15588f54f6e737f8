// Decoding a CUDA Graph node by node: host code on the runtime's and the
// driver's graph API, bound through a plain C ABI (no kernel here).
//
// Counterpart of: src/repro/core/hlo.py, parse_hlo.  The paper decodes the
//   pushbuffer a doorbell commits; the reference decodes the compiled HLO a
//   TPU consumes.  The port's submission unit is a captured CUDA Graph
//   (repro_torch/core/graphs.py, CapturedStep): its kernel, memcpy, memset,
//   event and conditional nodes are what the driver turns into pushbuffer
//   entries.  graph_decode reads them back in capture order, complete and
//   unsampled; repro_torch/core/stream.py::decode_graph walks the bodies.
// Kernel nodes are read through the driver (cuGraphKernelNodeGetParams,
//   cuFuncGetName / cuKernelGetName, CUDA 12.3 and later): cuBLAS and
//   PyTorch launch some kernels through cuLaunchKernel, whose functions the
//   runtime's cudaFuncGetName does not know.  The driver's entry points are
//   fetched with cudaGetDriverEntryPoint, so the library needs no -lcuda.
// Names come back mangled; each record also carries the name demangled by
//   the host compiler's abi::__cxa_demangle, as a profiler shows it.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cxxabi.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

namespace {

constexpr int kNameBytes = 1024;
// NodeRecord::stage: which read failed, for the caller's error message
enum { kStageNone, kStageType, kStageKernel, kStageMemcpy, kStageMemset, kStageChild };

// One node; mirrored by repro_torch/core/stream.py::_NodeRecord.
struct NodeRecord {
  int type;                      // CUgraphNodeType
  int status;                    // 0, or the error of a kernel name read
  int stage;                     // the call that failed (kStage*), or 0
  char name[kNameBytes];         // kernel: mangled name, "" if unreadable
  char demangled[kNameBytes];    // kernel: demangled name ("" if unreadable)
  unsigned int grid[3];
  unsigned int block[3];
  unsigned int cluster[3];       // 0s without a cluster attribute
  unsigned int shared_bytes;     // dynamic shared memory
  long long bytes;               // memcpy / memset bytes
  int direction;                 // memcpy: cudaMemcpyKind, Default resolved
  void* body;                    // child graph node: its graph
};

typedef CUresult (*NodeTypeFn)(CUgraphNode, CUgraphNodeType*);
typedef CUresult (*KernelParamsFn)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
typedef CUresult (*FuncNameFn)(const char**, CUfunction);
typedef CUresult (*KernelNameFn)(const char**, CUkernel);

struct Driver {
  NodeTypeFn node_type = nullptr;
  KernelParamsFn kernel_params = nullptr;
  FuncNameFn func_name = nullptr;
  KernelNameFn kernel_name = nullptr;   // absent on older drivers
};

template <typename F>
cudaError_t entry(const char* symbol, F* fn) {
  cudaDriverEntryPointQueryResult found;
  void* p = nullptr;
  cudaError_t err = cudaGetDriverEntryPoint(symbol, &p, cudaEnableDefault, &found);
  *fn = (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<F>(p)
                                                                      : nullptr;
  return err;
}

// cuKernelGetName may be missing from the driver (a lookup error there only
// leaves it null); the other three are required.  Node
// types come from the driver: the runtime's cudaGraphNodeGetType fails on a
// conditional node (cudaErrorUnknown on CUDA 12.8).
cudaError_t load_driver(Driver* d) {
  cudaError_t err;
  if ((err = entry("cuGraphNodeGetType", &d->node_type)) != cudaSuccess) return err;
  if ((err = entry("cuGraphKernelNodeGetParams", &d->kernel_params)) != cudaSuccess) return err;
  if ((err = entry("cuFuncGetName", &d->func_name)) != cudaSuccess) return err;
  if (entry("cuKernelGetName", &d->kernel_name) != cudaSuccess) cudaGetLastError();
  if (!d->node_type || !d->kernel_params || !d->func_name) return cudaErrorNotSupported;
  return cudaSuccess;
}

void copy_name(char* dst, const char* src) {
  strncpy(dst, src, kNameBytes - 1);
  dst[kNameBytes - 1] = '\0';
}

bool on_host(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();
    return true;
  }
  return a.type != cudaMemoryTypeDevice && a.type != cudaMemoryTypeManaged;
}

int read_kernel(const Driver& d, cudaGraphNode_t node, NodeRecord* r) {
  CUDA_KERNEL_NODE_PARAMS p;
  memset(&p, 0, sizeof(p));
  CUresult res = d.kernel_params(reinterpret_cast<CUgraphNode>(node), &p);
  if (res != CUDA_SUCCESS) return (int)res;
  r->grid[0] = p.gridDimX, r->grid[1] = p.gridDimY, r->grid[2] = p.gridDimZ;
  r->block[0] = p.blockDimX, r->block[1] = p.blockDimY, r->block[2] = p.blockDimZ;
  r->shared_bytes = p.sharedMemBytes;
  const char* name = nullptr;
  res = CUDA_ERROR_NOT_FOUND;
  if (p.func) res = d.func_name(&name, p.func);
  if (res != CUDA_SUCCESS && p.kern && d.kernel_name) res = d.kernel_name(&name, p.kern);
  if (res == CUDA_SUCCESS && name) {
    copy_name(r->name, name);
    int st = 0;
    char* dem = abi::__cxa_demangle(name, nullptr, nullptr, &st);
    copy_name(r->demangled, st == 0 && dem ? dem : name);
    free(dem);
  } else {
    r->status = (int)res;      // counted as <unnamed>, never dropped
  }
  cudaLaunchAttributeValue v;
  memset(&v, 0, sizeof(v));
  if (cudaGraphKernelNodeGetAttribute(node, cudaLaunchAttributeClusterDimension, &v) ==
      cudaSuccess) {
    r->cluster[0] = v.clusterDim.x, r->cluster[1] = v.clusterDim.y, r->cluster[2] = v.clusterDim.z;
  } else {
    cudaGetLastError();
  }
  return 0;
}

int read_memcpy(cudaGraphNode_t node, NodeRecord* r) {
  cudaMemcpy3DParms p;
  memset(&p, 0, sizeof(p));
  cudaError_t err = cudaGraphMemcpyNodeGetParams(node, &p);
  if (err != cudaSuccess) return (int)err;
  r->bytes = (long long)p.extent.width * (long long)(p.extent.height ? p.extent.height : 1) *
             (long long)(p.extent.depth ? p.extent.depth : 1);
  int kind = (int)p.kind;
  if (p.kind == cudaMemcpyDefault) {
    bool src_host = p.srcArray ? false : on_host(p.srcPtr.ptr);
    bool dst_host = p.dstArray ? false : on_host(p.dstPtr.ptr);
    kind = src_host ? (dst_host ? cudaMemcpyHostToHost : cudaMemcpyHostToDevice)
                    : (dst_host ? cudaMemcpyDeviceToHost : cudaMemcpyDeviceToDevice);
  }
  r->direction = kind;
  return 0;
}

int read_memset(cudaGraphNode_t node, NodeRecord* r) {
  cudaMemsetParams p;
  memset(&p, 0, sizeof(p));
  cudaError_t err = cudaGraphMemsetNodeGetParams(node, &p);
  if (err != cudaSuccess) return (int)err;
  r->bytes = (long long)p.elementSize * (long long)p.width * (long long)(p.height ? p.height : 1);
  r->direction = -1;
  return 0;
}

}  // namespace

// sizeof(NodeRecord), for the binding to check its mirror against.
extern "C" int graph_decode_record_bytes() { return (int)sizeof(NodeRecord); }

// The nodes of one cudaGraph_t (not of its bodies), in the order the graph
// holds them (capture order), as NodeRecords.  *n receives the node count;
// records is filled when capacity holds them all (call with records = NULL
// to size it).  Returns a CUDA error if a node cannot be read; a kernel's
// unreadable name is marked in the record instead.  A conditional node's
// bodies are not read here: the code that built the graph knows them.
extern "C" int graph_decode(void* graph, void* records, long long capacity, long long* n) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  NodeRecord* out = static_cast<NodeRecord*>(records);
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return (int)err;
  *n = (long long)count;
  if (out == nullptr || capacity < (long long)count) return 0;
  static Driver driver;
  static cudaError_t loaded = load_driver(&driver);
  if (loaded != cudaSuccess) {
    cudaGetLastError();
    return (int)loaded;
  }
  std::vector<cudaGraphNode_t> nodes(count);
  if (count && (err = cudaGraphGetNodes(g, nodes.data(), &count)) != cudaSuccess) return (int)err;
  int rc = 0;
  for (size_t i = 0; i < count && rc == 0; ++i) {
    NodeRecord* r = out + i;
    memset(r, 0, sizeof(*r));
    CUgraphNodeType type;
    CUresult res = driver.node_type(reinterpret_cast<CUgraphNode>(nodes[i]), &type);
    if (res != CUDA_SUCCESS) {
      rc = (int)res, r->stage = kStageType;
    } else {
      r->type = (int)type;       // the runtime's cudaGraphNodeType numbering
      switch (type) {
        case CU_GRAPH_NODE_TYPE_KERNEL:
          rc = read_kernel(driver, nodes[i], r), r->stage = rc ? kStageKernel : 0;
          break;
        case CU_GRAPH_NODE_TYPE_MEMCPY:
          rc = read_memcpy(nodes[i], r), r->stage = rc ? kStageMemcpy : 0;
          break;
        case CU_GRAPH_NODE_TYPE_MEMSET:
          rc = read_memset(nodes[i], r), r->stage = rc ? kStageMemset : 0;
          break;
        case CU_GRAPH_NODE_TYPE_GRAPH: {
          cudaGraph_t child;
          if ((err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child)) != cudaSuccess) {
            rc = (int)err, r->stage = kStageChild;
          } else {
            r->body = child;
          }
          break;
        }
        default:
          break;
      }
    }
    if (rc) {
      r->status = rc;
      *n = (long long)i;         // the node that could not be read
    }
  }
  cudaGetLastError();            // leave no error for the next launch's check
  return rc;
}
