// The engine's CUDA step kernel with the two-phase-commit policy:
// step_kernel<Tpc, N> for N = 2..8 (the spec needs two nodes). Built by
// madsim_tpu_torch/_build.py into a library of its own.
#include "actor_tpc.cuh"
#include "step_kernel.cuh"

// One engine step of every world, in place (see step_entry).
extern "C" int madsim_step(void* const* ptrs, int n_ptrs, const int* params,
                           int block, void* stream) {
  return step_entry<Tpc, 2>(ptrs, n_ptrs, params, block, stream);
}
