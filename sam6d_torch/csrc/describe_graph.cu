// The ISM describe sized on the device: a CUDA graph of one IF conditional
// node per 16-crop chunk, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no Pallas kernel. The JAX package describes only the first
// ceil(n_needed / chunk) chunks of its proposal buffer with a data-dependent
// lax.while_loop (or one lax.cond a chunk, `adaptive_unroll`), n_needed a
// device scalar (sam6d_tpu/pipelines/ism.py:82-143), so the host never waits
// for the valid flags. This file is the counterpart of the lax.cond a chunk:
// the caller (kernels/graphs.py) captures each chunk's DINOv2
// forward into a CUDA graph of its own (one body a chunk, reading a static
// crop buffer and writing static outputs, all bodies sharing one memory
// pool), and sam6d_describe_graph_build composes the parent graph
//
//   memset(outputs, 0) -> set_chunk_conditionals -> IF(c = 0) -> ... -> IF(c = n - 1)
//
// in which IF node c holds body c as a child graph and runs it when
// n_needed > c * chunk: set_chunk_conditionals, one thread a chunk, reads
// n_needed from its device address and sets each node's handle with
// cudaGraphSetConditional. Chunks past the prefix stay zero, as the JAX
// loop leaves them. The bodies run in chunk order, so the one pool they
// share is safe, and a chunk past the prefix skips every later one too.
//
// What bounds it: the set-up kernel and the memset are microseconds; the
// bodies are the describe's own work (24 DINOv2-L blocks a chunk).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxChunks = 64;
constexpr int kNodeTypes = 16;   // counted by cudaGraphNodeType value

struct Handles {
  cudaGraphConditionalHandle h[kMaxChunks];
};

__global__ void set_chunk_conditionals(Handles handles, int n_chunks, const int* n_needed,
                                       int chunk) {
  const int c = threadIdx.x;
  if (c < n_chunks) cudaGraphSetConditional(handles.h[c], *n_needed > c * chunk ? 1u : 0u);
}

int count_node_types(cudaGraph_t g, int* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err == cudaSuccess && static_cast<int>(t) >= 0 && static_cast<int>(t) < kNodeTypes)
      ++counts[static_cast<int>(t)];
  }
  delete[] nodes;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// bodies: n_chunks cudaGraph_t (body c = chunk c's forward, its outputs
// written into the caller's static buffers); zero_ptrs / zero_bytes: the
// n_zero output buffers cleared at each launch; n_needed: a device int32
// read at each launch; chunk: crops a chunk. On success *exec_out and
// *graph_out hold the instantiated graph and its parent graph (free both
// with sam6d_describe_graph_destroy), and node_counts[t] counts the bodies'
// nodes of cudaGraphNodeType t (kNodeTypes entries). Returns a CUDA error
// code (0 on success).
int sam6d_describe_graph_build(void** bodies, int n_chunks, void** zero_ptrs,
                               long long* zero_bytes, int n_zero, const int* n_needed,
                               int chunk, void** exec_out, void** graph_out,
                               int* node_counts) {
  if (n_chunks < 1 || n_chunks > kMaxChunks || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < kNodeTypes; ++t) node_counts[t] = 0;
  cudaGraph_t parent = nullptr;
  cudaError_t err = cudaGraphCreate(&parent, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n_zero && err == cudaSuccess; ++i) {
    cudaMemsetParams m = {};
    m.dst = zero_ptrs[i];
    m.value = 0;
    m.elementSize = zero_bytes[i] % 4 == 0 ? 4 : 1;
    m.width = static_cast<size_t>(zero_bytes[i]) / m.elementSize;
    m.height = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddMemsetNode(&node, parent, prev ? &prev : nullptr, prev ? 1 : 0, &m);
    prev = node;
  }
  Handles handles = {};
  for (int c = 0; c < n_chunks && err == cudaSuccess; ++c)
    err = cudaGraphConditionalHandleCreate(&handles.h[c], parent, 0, cudaGraphCondAssignDefault);
  if (err == cudaSuccess) {
    void* args[] = {&handles, &n_chunks, const_cast<int**>(&n_needed), &chunk};
    cudaKernelNodeParams k = {};
    k.func = reinterpret_cast<void*>(set_chunk_conditionals);
    k.gridDim = dim3(1);
    k.blockDim = dim3(kMaxChunks);
    k.sharedMemBytes = 0;
    k.kernelParams = args;
    cudaGraphNode_t node;
    err = cudaGraphAddKernelNode(&node, parent, prev ? &prev : nullptr, prev ? 1 : 0, &k);
    prev = node;
  }
  for (int c = 0; c < n_chunks && err == cudaSuccess; ++c) {
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = handles.h[c];
    p.conditional.type = cudaGraphCondTypeIf;
    p.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, parent, &prev, 1, &p);
    if (err != cudaSuccess) break;
    prev = node;
    cudaGraphNode_t child;
    const cudaGraph_t body = static_cast<cudaGraph_t>(bodies[c]);
    err = cudaGraphAddChildGraphNode(&child, p.conditional.phGraph_out[0], nullptr, 0, body);
    if (err == cudaSuccess) err = static_cast<cudaError_t>(count_node_types(body, node_counts));
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, parent, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(parent);
    return static_cast<int>(err);
  }
  *exec_out = exec;
  *graph_out = parent;
  return 0;
}

// One run of a built describe graph on `stream`.
int sam6d_describe_graph_launch(void* exec, cudaStream_t stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), stream));
}

int sam6d_describe_graph_destroy(void* exec, void* graph) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}

// The cudaGraphNodeType count the node_counts array of the build carries.
int sam6d_describe_graph_node_types() { return kNodeTypes; }

}  // extern "C"
