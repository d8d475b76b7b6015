// The entity solver's tron mode in double, for the twice-differentiable
// losses (see entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

int launch_tron_f64(const Params& p, int loss, cudaStream_t stream) {
  return launch_loss<double, kModeTron>(p, loss, stream);
}

}  // namespace entity_lbfgs
