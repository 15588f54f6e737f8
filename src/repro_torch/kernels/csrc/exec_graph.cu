// The node of the paper's CUDA-Graph benchmark for Hopper (sm_90a), and the
// graphs built from it, bound through a plain C ABI.
//
// Counterpart of: src/repro/core/graphs.py, ExecGraph._node (x * scale over a
//   width-element array; XLA compiles it on the TPU) and the lax.scan of its
//   multistep mode.  The paper's section 6.3 launches a linear chain of K
//   identical small kernels; so does repro_torch/core/graphs.py, in three
//   modes that differ only in how the same node kernel is submitted:
//   per_op (K launches), graphed (K launches captured into one graph) and
//   multistep (one graph whose conditional WHILE node runs a one-node body K
//   times, built here with the runtime's graph API).
// Bound: bytes.  A node reads and writes width floats (32 KiB at width 4096,
//   far below the card's 50 MB L2), so what a chain costs is its launches:
//   the host's submissions (per_op) or the graph's own dispatch (graphed,
//   multistep).  Blocks of 256 threads, one float a thread per pass.
// The node reads its scale as scales[*index]: per_op and graphed point index
//   at a fixed entry of a [0, K) table, multistep at the loop's step counter,
//   so one kernel serves all three modes.
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdlib.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
    exec_graph_node_kernel(float* x, const float* scales, const int* index, int width) {
  const float s = scales[*index];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < width; i += gridDim.x * blockDim.x)
    x[i] *= s;
}

// The WHILE body's second node: one thread advances the step counter and
// keeps the loop going while it is below K.
__global__ void exec_graph_advance_kernel(int* counter, int k, cudaGraphConditionalHandle handle) {
  const int c = *counter + 1;
  *counter = c;
  cudaGraphSetConditional(handle, c < k ? 1u : 0u);
}

dim3 node_grid(int width) {
  int blocks = (width + kThreads - 1) / kThreads;
  return dim3(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

// The multistep graph: memset(counter) -> WHILE(handle) { node; advance }.
struct Multistep {
  cudaGraph_t graph = nullptr;
  cudaGraph_t body = nullptr;       // owned by the conditional node
  cudaGraphExec_t exec = nullptr;
};

}  // namespace

// Loads the kernels' module, so that neither a capture nor a graph build
// loads it lazily.
extern "C" int exec_graph_prepare() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, exec_graph_node_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, exec_graph_advance_kernel);
}

// One node on the given stream: x[i] *= scales[*index] for i < width.
extern "C" int exec_graph_node(float* x, const float* scales, const int* index, int width,
                               void* stream) {
  if (width < 1) return (int)cudaErrorInvalidValue;
  exec_graph_node_kernel<<<node_grid(width), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scales, index, width);
  return (int)cudaGetLastError();
}

// Builds and instantiates the multistep graph of K nodes over x, with the
// step counter at counter (one int of device memory), and uploads it on the
// given stream.  *out receives an opaque handle for the calls below.
extern "C" int exec_graph_multistep_build(float* x, const float* scales, int* counter, int k,
                                          int width, void* stream, void** out) {
  if (k < 1 || width < 1) return (int)cudaErrorInvalidValue;
  Multistep* m = new Multistep();
  cudaError_t err;
#define TRY(call)                     \
  if ((err = (call)) != cudaSuccess) { \
    delete m;                         \
    return (int)err;                  \
  }
  TRY(cudaGraphCreate(&m->graph, 0));
  cudaGraphConditionalHandle handle;
  // the loop runs at least once (K >= 1): every launch starts the condition at 1
  TRY(cudaGraphConditionalHandleCreate(&handle, m->graph, 1u, cudaGraphCondAssignDefault));

  cudaMemsetParams ms = {};
  ms.dst = counter;
  ms.value = 0;
  ms.elementSize = sizeof(int);
  ms.width = 1;
  ms.height = 1;
  cudaGraphNode_t reset;
  TRY(cudaGraphAddMemsetNode(&reset, m->graph, nullptr, 0, &ms));

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  TRY(cudaGraphAddNode(&loop, m->graph, &reset, 1, &cp));
  m->body = cp.conditional.phGraph_out[0];

  void* node_args[] = {&x, &scales, &counter, &width};
  cudaKernelNodeParams np = {};
  np.func = (void*)exec_graph_node_kernel;
  np.gridDim = node_grid(width);
  np.blockDim = dim3(kThreads);
  np.kernelParams = node_args;
  cudaGraphNode_t node;
  TRY(cudaGraphAddKernelNode(&node, m->body, nullptr, 0, &np));

  void* adv_args[] = {&counter, &k, &handle};
  cudaKernelNodeParams ap = {};
  ap.func = (void*)exec_graph_advance_kernel;
  ap.gridDim = dim3(1);
  ap.blockDim = dim3(1);
  ap.kernelParams = adv_args;
  cudaGraphNode_t advance;
  TRY(cudaGraphAddKernelNode(&advance, m->body, &node, 1, &ap));

  TRY(cudaGraphInstantiate(&m->exec, m->graph, 0));
  TRY(cudaGraphUpload(m->exec, static_cast<cudaStream_t>(stream)));
#undef TRY
  *out = m;
  return 0;
}

extern "C" int exec_graph_multistep_launch(void* handle, void* stream) {
  return (int)cudaGraphLaunch(static_cast<Multistep*>(handle)->exec,
                              static_cast<cudaStream_t>(stream));
}

// The multistep graph's top-level graph and its WHILE body, as cudaGraph_t
// handles for graph_footprint.
extern "C" void exec_graph_multistep_graphs(void* handle, void** graph, void** body) {
  const Multistep* m = static_cast<const Multistep*>(handle);
  *graph = m->graph;
  *body = m->body;
}

extern "C" int exec_graph_multistep_destroy(void* handle) {
  Multistep* m = static_cast<Multistep*>(handle);
  cudaError_t err = cudaSuccess;
  if (m->exec) err = cudaGraphExecDestroy(m->exec);
  if (m->graph && err == cudaSuccess) err = cudaGraphDestroy(m->graph);   // and its body
  delete m;
  return (int)err;
}

// Uploads an instantiated graph to the device on the given stream, so that
// its first launch does not pay for it.
extern "C" int graph_upload(void* exec, void* stream) {
  return (int)cudaGraphUpload(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

// The footprint of one cudaGraph_t (not of its child or conditional
// graphs): *nodes receives its node count (cudaGraphGetNodes) and *bytes the
// size of its verbose description (cudaGraphDebugDotPrint), which is written
// to dot_path.
extern "C" int graph_footprint(void* graph, const char* dot_path, long long* nodes,
                               long long* bytes) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  err = cudaGraphDebugDotPrint(g, dot_path, cudaGraphDebugDotFlagsVerbose);
  if (err != cudaSuccess) return (int)err;
  FILE* f = fopen(dot_path, "rb");
  if (!f) return (int)cudaErrorInvalidValue;
  fseek(f, 0, SEEK_END);
  *bytes = ftell(f);
  fclose(f);
  *nodes = (long long)n;
  return 0;
}
