// The engine's CUDA step kernel with the primary-backup policy:
// step_kernel<Pb, N> for N = 1..8. Built by madsim_tpu_torch/_build.py into
// a library of its own.
#include "actor_pb.cuh"
#include "step_kernel.cuh"

// One engine step of every world, in place (see step_entry), behind the
// gate word at gate, in the packed (wide = 0) or the wide lane profile.
extern "C" int madsim_step_ex(void* const* ptrs, int n_ptrs,
                              const int* params, int block, void* stream,
                              const void* gate, int wide) {
  const int* g = static_cast<const int*>(gate);
  if (wide)
    return step_entry<PbWide, 1>(ptrs, n_ptrs, params, block, stream,
                                   g);
  return step_entry<Pb, 1>(ptrs, n_ptrs, params, block, stream, g);
}
