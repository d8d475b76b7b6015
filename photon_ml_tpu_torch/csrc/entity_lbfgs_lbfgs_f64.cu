// The entity solver's lbfgs mode in double, for every loss and layout
// (see entity_lbfgs.cu).

#include "entity_lbfgs.cuh"

namespace entity_lbfgs {

KernelFn kernel_lbfgs_f64(const Plan& plan, int loss) {
  return unit_kernel<double, kModeLbfgs>(plan, loss);
}

}  // namespace entity_lbfgs
