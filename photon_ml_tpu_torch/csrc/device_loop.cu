// The device loop's WHILE node (photon_ml_tpu_torch/utils/device_loop.py):
// the port's counterpart of the lax.while_loop that JAX compiles into one
// XLA executable (photon_ml_tpu/optimization/glm_lbfgs.py:181, lbfgs.py
// :225 and :342, owlqn.py:174, tron.py:108 and :283). It replaces no
// Pallas kernel: it keeps a solver's iterations on the card, where the
// host loop read every iteration's stop reason back.
//
// While a stream captures a CUDA graph, device_loop_open adds a
// conditional WHILE node to the graph being captured, sets its condition
// from a device bool before the node (so a loop whose predicate is false
// runs no body), and starts capturing a second stream into the node's
// body graph. The caller records the loop body on that stream; then
// device_loop_close sets the condition from the predicate the body
// computed and ends the body's capture. The device re-runs the body while
// the condition is 1, so a solve stops where its stop test says, with no
// host read. set_condition is one thread: what bounds it is its launch.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int device_loop_open(void* parent, void* body,
                                const unsigned char* pred,
                                unsigned long long* handle_out,
                                void** body_graph_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph,
                                           &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_condition<<<1, 1, 0, ps>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  e = cudaStreamBeginCaptureToGraph(bs, body_graph, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle_out = handle;
  *body_graph_out = body_graph;
  return 0;
}

extern "C" int device_loop_close(void* body, unsigned long long handle,
                                 const unsigned char* pred) {
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  set_condition<<<1, 1, 0, bs>>>(handle, pred);
  cudaError_t launch = cudaGetLastError();
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaStreamEndCapture(bs, &g);
  return (int)(launch != cudaSuccess ? launch : e);
}

// Ends a body capture left open by a fault in the body (nothing to do if
// the stream is not capturing).
extern "C" int device_loop_abort(void* body) {
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  cudaStreamCaptureStatus status;
  cudaError_t e = cudaStreamIsCapturing(bs, &status);
  if (e != cudaSuccess) return (int)e;
  if (status == cudaStreamCaptureStatusNone) return 0;
  cudaGraph_t g = nullptr;
  return (int)cudaStreamEndCapture(bs, &g);
}

// The nodes of one graph, a conditional node counted as one (its body is
// a graph of its own).
extern "C" long long device_loop_nodes(void* graph) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr,
                                    &n);
  return e == cudaSuccess ? (long long)n : -(long long)e;
}
