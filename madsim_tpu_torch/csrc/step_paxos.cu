// The engine's CUDA step kernel with the multi-decree Paxos policy:
// step_kernel<Paxos, N> for N = 1..8. Built by madsim_tpu_torch/_build.py
// into a library of its own.
#include "actor_paxos.cuh"
#include "step_kernel.cuh"

// One engine step of every world, in place (see step_entry).
extern "C" int madsim_step(void* const* ptrs, int n_ptrs, const int* params,
                           int block, void* stream) {
  return step_entry<Paxos, 1>(ptrs, n_ptrs, params, block, stream);
}
