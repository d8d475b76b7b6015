// Kernel row 10 in float32: see csr_spmm.cuh (what it stands for) and
// csr_order.cuh (the order contract and the kernel).

#include "csr_spmm.cuh"

// Launch Y = A X on `stream` for the CSR A of `call` and a row-major panel
// X of call->n columns. Returns the CUDA error of the first failed launch
// (0 on success). Does not synchronise; the counters are 0 again after
// the launches.
extern "C" int csr_spmm_f32_run(const csr_order::Call* call, const float* X,
                                float* Y, void* stream) {
  return csr_spmm::launch<float>(call, X, Y, stream);
}
