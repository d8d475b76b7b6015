// The entity solver's owlqn mode in float, for every loss and layout
// (see entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

KernelFn kernel_owlqn_f32(const Plan& plan, int loss) {
  return unit_kernel<float, kModeOwlqn>(plan, loss);
}

}  // namespace entity_lbfgs
