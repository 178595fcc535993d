// The engine's CUDA step kernel with the pair-restart policy (both pair
// families): step_kernel<Pair, N> for N = 1..12. Built by
// madsim_tpu_torch/_build.py into a library of its own.
#include "actor_pair.cuh"
#include "step_kernel.cuh"

// One engine step of every world, in place (see step_entry).
extern "C" int madsim_step(void* const* ptrs, int n_ptrs, const int* params,
                           int block, void* stream) {
  return step_entry<Pair, 1>(ptrs, n_ptrs, params, block, stream);
}
