// CUDA-graph IF nodes for a stream capture in progress: the device-side
// exit of the fixed-budget Krylov loops (`solvers/graphs.py`), the
// counterpart of the `cond` of the JAX package's `lax.while_loop`.
//
// graph_if_begin(pred, body, stream): on `stream`, which is capturing,
// adds a one-thread kernel that sets a conditional handle from the bool at
// `pred` (a device address, read when the graph runs), then an IF node on
// that handle after it, and starts capturing `body` (a stream that is not
// capturing) into the node's body graph. Work enqueued on `body` until
// graph_if_end(body) runs in a replay only where *pred was true when the
// kernel read it. The stream's later work depends on the IF node.
//
// Both return a cudaError_t as int (0 on success); graph_cond_error_string
// names it. Needs CUDA 12.4 or later (conditional nodes, capture to a
// graph).

#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// the graph `s` captures into and the nodes its next work depends on
static cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, n);
#else
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorIllegalState;
}

extern "C" {

const char* graph_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int graph_if_begin(const void* pred, void* body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &graph, &deps, &n);   // now: the set kernel
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

int graph_if_end(void* stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &body);
}

}  // extern "C"
