// The engine's CUDA step kernel with the pair-restart policy (both pair
// families): step_kernel<Pair, N> for N = 1..12. Built by
// madsim_tpu_torch/_build.py into a library of its own.
#include "actor_pair.cuh"
#include "step_kernel.cuh"

// One engine step of every world, in place (see step_entry), behind the
// gate word at gate, in the packed (wide = 0) or the wide lane profile.
extern "C" int madsim_step_ex(void* const* ptrs, int n_ptrs,
                              const int* params, int block, void* stream,
                              const void* gate, int wide) {
  const int* g = static_cast<const int*>(gate);
  if (wide)
    return step_entry<PairWide, 1>(ptrs, n_ptrs, params, block, stream,
                                   g);
  return step_entry<Pair, 1>(ptrs, n_ptrs, params, block, stream, g);
}
