// The entity solver's tron mode in float, for the twice-differentiable
// losses, in every layout (see entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

KernelFn kernel_tron_f32(const Plan& plan, int loss) {
  return unit_kernel<float, kModeTron>(plan, loss);
}

}  // namespace entity_lbfgs
