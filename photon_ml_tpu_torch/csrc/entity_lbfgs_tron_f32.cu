// The entity solver's tron mode in float, for the twice-differentiable
// losses (see entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

int launch_tron_f32(const Params& p, int loss, cudaStream_t stream) {
  return launch_loss<float, kModeTron>(p, loss, stream);
}

}  // namespace entity_lbfgs
