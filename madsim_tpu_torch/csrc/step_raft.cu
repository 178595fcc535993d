// The engine's CUDA step kernel with the Raft policy: step_kernel<Raft, N>
// for N = 1..8, and the Threefry test kernel. Built by
// madsim_tpu_torch/_build.py into a library of its own, beside those of
// step_tpc.cu and step_pb.cu, so the three build in parallel.
#include "actor_raft.cuh"
#include "step_kernel.cuh"

namespace {

__global__ void threefry_kernel(const uint32_t* k0, const uint32_t* k1,
                                const uint32_t* c0, const uint32_t* c1,
                                uint32_t* o0, uint32_t* o1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  threefry2x32(k0[i], k1[i], c0[i], c1[i], o0[i], o1[i]);
}

}  // namespace

// One engine step of every world, in place (see step_entry), behind the
// gate word at gate, in the packed (wide = 0) or the wide lane profile.
extern "C" int madsim_step_ex(void* const* ptrs, int n_ptrs,
                              const int* params, int block, void* stream,
                              const void* gate, int wide) {
  const int* g = static_cast<const int*>(gate);
  if (wide)
    return step_entry<RaftWide, 1>(ptrs, n_ptrs, params, block, stream,
                                   g);
  return step_entry<Raft, 1>(ptrs, n_ptrs, params, block, stream, g);
}

// Threefry-2x32/20 of n (key, counter) pairs: the kernel's own device
// function, exported so the Random123 known answers can be checked on the
// card.
extern "C" int madsim_threefry(const void* k0, const void* k1,
                               const void* c0, const void* c1, void* o0,
                               void* o1, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int block = 256;
  threefry_kernel<<<(n + block - 1) / block, block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k0), static_cast<const uint32_t*>(k1),
      static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1),
      static_cast<uint32_t*>(o0), static_cast<uint32_t*>(o1), n);
  return (int)cudaGetLastError();
}
