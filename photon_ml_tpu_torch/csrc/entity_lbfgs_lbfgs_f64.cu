// The entity solver's lbfgs mode in double, for every loss (see
// entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

int launch_lbfgs_f64(const Params& p, int loss, cudaStream_t stream) {
  return launch_loss<double, kModeLbfgs>(p, loss, stream);
}

}  // namespace entity_lbfgs
