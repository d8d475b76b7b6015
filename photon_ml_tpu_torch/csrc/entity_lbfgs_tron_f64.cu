// The entity solver's tron mode in double, for the twice-differentiable
// losses, in every layout (see entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

KernelFn kernel_tron_f64(const Plan& plan, int loss) {
  return unit_kernel<double, kModeTron>(plan, loss);
}

}  // namespace entity_lbfgs
