// The entity solver's owlqn mode in float, for every loss (see
// entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

int launch_owlqn_f32(const Params& p, int loss, cudaStream_t stream) {
  return launch_loss<float, kModeOwlqn>(p, loss, stream);
}

}  // namespace entity_lbfgs
