// The guided search's corpus insertion fold as one CUDA kernel for sm_90a.
//
// The device half of madsim_tpu/search/corpus.py::harvest_fold (:131-200),
// which the JAX package runs as a sequential fori_loop inside its searcher
// and fused-hunt programs (an XLA program, not a Pallas kernel). The plain
// version is madsim_tpu_torch/search/corpus.py::harvest_fold, a loop of
// torch ops; the two agree bit for bit.
//
// The rule. Rows j = 0..W-1 are taken in order, each against the corpus as
// the rows before it left it. For a row in the fold mask:
// - its novelty is the least popcount(sig[j] ^ corpus.sig[e]) over the
//   filled entries e, or EMPTY_NOVELTY (33) where none is filled;
// - the target is the first index of the least key, key[e] = score[e]
//   where filled, else -1;
// - the row is novel when its novelty is at least min_novelty, and is
//   inserted when it is novel and its novelty is above key[target]: the
//   target entry takes its schedule, signature, novelty as score, its
//   lineage entry id and depth, and becomes filled.
//
// Design: one warp, the corpus's signatures and keys in shared memory. The
// row loop is sequential (each row sees the inserts of the rows before
// it); within a row each lane scans every 32nd entry and the warp reduces
// the least novelty and the (key, index) least pair with shuffles, so ties
// go to the lowest index as jnp.argmin's do. An insert is written by lane
// 0 to shared and device memory, the schedule row copied by the whole warp.
// A row outside the mask costs one byte read. Signatures are int64 values
// in [0, 2^32) (the port's device carrier of a u32); the popcount reads
// their low word.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int EMPTY_NOVELTY = 33;
constexpr int MAX_K = 4096;

__global__ void corpus_fold_kernel(
    int32_t* c_sched, int64_t* c_sig, int32_t* c_score, uint8_t* c_filled,
    int32_t* c_entry, int32_t* c_depth, int32_t* c_inserted,
    const int32_t* sched, const int64_t* sigs, const uint8_t* mask,
    const int32_t* entries, const int32_t* depths, uint8_t* nov_m,
    uint8_t* ins_m, int32_t* n_ins_out, int K, int row_words, int W,
    int min_novelty) {
  __shared__ uint32_t sig[MAX_K];
  __shared__ int32_t key[MAX_K];
  __shared__ uint8_t fil[MAX_K];
  const int lane = threadIdx.x;
  for (int e = lane; e < K; e += 32) {
    sig[e] = (uint32_t)c_sig[e];
    fil[e] = c_filled[e];
    key[e] = fil[e] ? c_score[e] : -1;
  }
  __syncwarp();
  int n_ins = 0;
  for (int j = 0; j < W; j++) {
    if (!mask[j]) {
      if (lane == 0) {
        nov_m[j] = 0;
        ins_m[j] = 0;
      }
      continue;
    }
    const uint32_t s = (uint32_t)sigs[j];
    int nov = EMPTY_NOVELTY, bkey = 0x7FFFFFFF, bidx = K;
    for (int e = lane; e < K; e += 32) {
      const int k = key[e];
      if (fil[e]) nov = min(nov, __popc(s ^ sig[e]));
      if (k < bkey) {
        bkey = k;
        bidx = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      nov = min(nov, __shfl_xor_sync(0xFFFFFFFFu, nov, off));
      const int ok = __shfl_xor_sync(0xFFFFFFFFu, bkey, off);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, bidx, off);
      if (ok < bkey || (ok == bkey && oi < bidx)) {
        bkey = ok;
        bidx = oi;
      }
    }
    const bool novel = nov >= min_novelty;
    const bool ins = novel && nov > bkey;
    if (lane == 0) {
      nov_m[j] = novel;
      ins_m[j] = ins;
    }
    if (ins) {
      const int t = bidx;
      for (int x = lane; x < row_words; x += 32)
        c_sched[(size_t)t * row_words + x] = sched[(size_t)j * row_words + x];
      if (lane == 0) {
        sig[t] = s;
        key[t] = nov;
        fil[t] = 1;
        c_sig[t] = sigs[j];
        c_score[t] = nov;
        c_filled[t] = 1;
        c_entry[t] = entries[j];
        c_depth[t] = depths[j];
      }
      n_ins++;
    }
    __syncwarp();
  }
  if (lane == 0) {
    *n_ins_out = n_ins;
    *c_inserted = (int32_t)((uint32_t)*c_inserted + (uint32_t)n_ins);
  }
}

// The fold's dependent chain alone, a yardstick for its latency: rows
// rounds of the (key, index) least-pair scan and shuffle reduction, each
// round's target taking a higher key (the insert) before the next round
// reads the keys, with no device memory traffic. A fold of that many
// masked rows cannot take less time in this design: its row loop runs
// this chain, and every other step of a row can overlap it.
__global__ void fold_chain_kernel(int rows, int K, int32_t* out) {
  __shared__ int32_t key[MAX_K];
  const int lane = threadIdx.x;
  for (int e = lane; e < K; e += 32) key[e] = e;
  __syncwarp();
  for (int j = 0; j < rows; j++) {
    int bkey = 0x7FFFFFFF, bidx = K;
    for (int e = lane; e < K; e += 32) {
      const int k = key[e];
      if (k < bkey) {
        bkey = k;
        bidx = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(0xFFFFFFFFu, bkey, off);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, bidx, off);
      if (ok < bkey || (ok == bkey && oi < bidx)) {
        bkey = ok;
        bidx = oi;
      }
    }
    if (lane == 0) key[bidx] = bkey + K;
    __syncwarp();
  }
  if (lane == 0) *out = key[0];
}

}  // namespace

// The fold over W rows, in place on the corpus (c_*: K entries, c_sched
// K x row_words int32, c_inserted the insert counter), writing the per-row
// novel and inserted masks and this fold's insert count. One launch of one
// warp on the given stream; returns its CUDA status.
extern "C" int madsim_corpus_fold(
    void* c_sched, void* c_sig, void* c_score, void* c_filled, void* c_entry,
    void* c_depth, void* c_inserted, const void* sched, const void* sigs,
    const void* mask, const void* entries, const void* depths, void* nov_m,
    void* ins_m, void* n_ins, int K, int row_words, int W, int min_novelty,
    void* stream) {
  if (K < 1 || K > MAX_K || row_words < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  corpus_fold_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(c_sched), static_cast<int64_t*>(c_sig),
      static_cast<int32_t*>(c_score), static_cast<uint8_t*>(c_filled),
      static_cast<int32_t*>(c_entry), static_cast<int32_t*>(c_depth),
      static_cast<int32_t*>(c_inserted), static_cast<const int32_t*>(sched),
      static_cast<const int64_t*>(sigs), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(entries),
      static_cast<const int32_t*>(depths), static_cast<uint8_t*>(nov_m),
      static_cast<uint8_t*>(ins_m), static_cast<int32_t*>(n_ins), K,
      row_words, W, min_novelty);
  return (int)cudaGetLastError();
}

// The dependent chain of a fold of rows masked rows over K entries (see
// fold_chain_kernel): one launch of one warp, writing one int to out.
extern "C" int madsim_fold_chain(int rows, int K, void* out, void* stream) {
  if (K < 1 || K > MAX_K || rows < 0) return (int)cudaErrorInvalidValue;
  fold_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, K, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
