// Kernel row 10 in float64: see csr_spmm.cuh and csr_order.cuh.

#include "csr_spmm.cuh"

extern "C" int csr_spmm_f64_run(const csr_order::Call* call, const double* X,
                                double* Y, void* stream) {
  return csr_spmm::launch<double>(call, X, Y, stream);
}
