// The guided search's corpus insertion fold as one CUDA kernel for sm_90a.
//
// It replaces the XLA program madsim_tpu/search/corpus.py:131 harvest_fold
// (:131-200), which the JAX package runs as a sequential fori_loop inside
// its searcher and fused-hunt programs (not a Pallas kernel). The plain
// version is madsim_tpu_torch/search/corpus.py::harvest_fold_plain, a loop
// of torch ops; the two agree bit for bit.
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
// What bounds it on this card. A fold moves a few kilobytes (0.03 us at
// the HBM rate), so bytes never bound it: the dependent chain of the rule
// and the launch do. The first kernel (one warp, row after row, two
// shuffle reductions per row) spent 213 ns a row on that chain alone; a
// fold of 8,192 rows took 2.8 ms on an H100.
//
// The design. Two facts of the rule break the chain. The least (key,
// index) pair changes only at an insert, so between inserts it is a
// block-uniform constant. And a row depends on the rows before it only
// through their inserts, so the rows between two inserts are independent.
// One block of FOLD_THREADS threads:
// - stages the corpus in shared memory: the filled entries' signatures as
//   a list (each entry's place in it beside), every entry's key, and the
//   row that last landed in it; then the fold rows' mask and signatures,
//   in segments of up to SEG_ROWS rows, read together; and writes the two
//   zero mask bytes of every row outside the mask, coalesced;
// - takes the rows in rounds of FOLD_THREADS, one row a thread: each
//   masked row scans the filled signatures for its novelty (broadcast
//   16-byte reads, popcount and min, no shuffle) and tests "would insert"
//   against the uniform pair; a warp without a masked row skips the scan;
// - finds the round's first inserting row f with one ballot a warp and one
//   barrier; the rows before f commit their masks; row f's thread writes
//   the insert to shared memory (an unfilled target joins the list);
//   after a barrier every warp refreshes the pair with one (key, index)
//   reduction (ties to the lowest index, as jnp.argmin's); the next round
//   starts at row f + 1;
// - writes the new corpus out of place at the end: each entry from the
//   row that last landed in it, or from the old corpus, so a fold is one
//   launch and the old corpus is never cloned. Null entries/depths
//   pointers stand for -1 and 0.
// So the dependent chain is one barrier per round of FOLD_THREADS rows and
// one more barrier and reduction per insert, where it was two reductions
// per row. A round's scan is one popcount per row and filled entry, and
// popcount issues at a quarter of the integer rate: the list skips the
// unfilled entries, which a hunt's young corpus is mostly made of. A
// larger block wastes more of a round at each insert, a smaller one pays
// more barriers. At K = MAX_K a full corpus makes each round slow, but the
// fold stays exact. Signatures are int64 values in [0, 2^32) (the port's
// device carrier of a u32); the popcount reads their low word.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int EMPTY_NOVELTY = 33;
constexpr int MAX_K = 4096;
constexpr int FOLD_THREADS = 256;
constexpr int N_WARPS = FOLD_THREADS / 32;
constexpr int SEG_ROWS = 4096;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

// The fold's pointers, in the order the C entry takes them.
struct FoldPtrs {
  const int32_t* c_sched;
  const int64_t* c_sig;
  const int32_t* c_score;
  const uint8_t* c_filled;
  const int32_t* c_entry;
  const int32_t* c_depth;
  const int32_t* c_inserted;
  const int32_t* sched;
  const int64_t* sigs;
  const uint8_t* mask;
  const int32_t* entries;  // may be null: every row's entry id is -1
  const int32_t* depths;   // may be null: every row's depth is 0
  int32_t* o_sched;
  int64_t* o_sig;
  int32_t* o_score;
  uint8_t* o_filled;
  int32_t* o_entry;
  int32_t* o_depth;
  int32_t* o_inserted;
  uint8_t* nov_m;
  uint8_t* ins_m;
  int32_t* n_ins;
};
constexpr int N_PTRS = sizeof(FoldPtrs) / sizeof(void*);

// (key, index) as one unsigned 64-bit word whose order is the pair's
// lexicographic order: the key's sign bit flipped, then the index.
__device__ __forceinline__ unsigned long long pack_pair(int key, int idx) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)idx;
}

__device__ __forceinline__ int pair_key(unsigned long long p) {
  return (int)((unsigned)(p >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int pair_index(unsigned long long p) {
  return (int)(unsigned)(p & 0xFFFFFFFFull);
}

// The least (key, index) pair over key[0..K), the same in every lane of
// the calling warp.
__device__ __forceinline__ unsigned long long least_pair(const int32_t* key,
                                                         int K, int lane) {
  unsigned long long best = ~0ull;
  for (int e = lane; e < K; e += 32) {
    const unsigned long long p = pack_pair(key[e], e);
    best = p < best ? p : best;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, best, off);
    best = o < best ? o : best;
  }
  return best;
}

// A row's novelty against the n filled entries' signatures fsig[0..n)
// (16-byte aligned): the least popcount of the XOR, EMPTY_NOVELTY where n
// is 0. Four running minima over 16-byte reads.
__device__ __forceinline__ int novelty_of(unsigned s, const uint32_t* fsig,
                                          int n) {
  int n0 = EMPTY_NOVELTY, n1 = EMPTY_NOVELTY, n2 = EMPTY_NOVELTY,
      n3 = EMPTY_NOVELTY;
  const uint4* q = reinterpret_cast<const uint4*>(fsig);
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    const uint4 v = q[j >> 2];
    n0 = min(n0, __popc(s ^ v.x));
    n1 = min(n1, __popc(s ^ v.y));
    n2 = min(n2, __popc(s ^ v.z));
    n3 = min(n3, __popc(s ^ v.w));
  }
  for (; j < n; j++) n0 = min(n0, __popc(s ^ fsig[j]));
  return min(min(n0, n1), min(n2, n3));
}

// The first thread of the block whose warp ballot in wb is set, or
// FOLD_THREADS where none is.
__device__ __forceinline__ int first_set(const unsigned* wb) {
  int f = FOLD_THREADS;
#pragma unroll
  for (int w = N_WARPS - 1; w >= 0; w--) {
    const unsigned b = wb[w];
    if (b) f = w * 32 + __ffs(b) - 1;
  }
  return f;
}

// Dynamic shared memory: fsig (K), fpos (K), key (K), src (K), then the
// segment's signatures (seg) and mask bytes (seg).
size_t fold_smem_bytes(int K, int seg) {
  return (size_t)K * 16 + (size_t)seg * 5;
}

__global__ void __launch_bounds__(FOLD_THREADS) corpus_fold_kernel(
    FoldPtrs p, int K, int row_words, int W, int seg, int min_novelty) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* fsig = reinterpret_cast<uint32_t*>(smem);
  int32_t* fpos = reinterpret_cast<int32_t*>(fsig + K);
  int32_t* key = fpos + K;
  int32_t* src = key + K;
  uint32_t* ssig = reinterpret_cast<uint32_t*>(src + K);
  uint8_t* smask = reinterpret_cast<uint8_t*>(ssig + seg);
  __shared__ unsigned wb[2][N_WARPS];
  __shared__ int nf_sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Inputs are read with __ldg (read-only, never written by the fold), so
  // the loads of a loop issue together instead of each behind the last
  // iteration's stores. Warp 0 lists the filled entries' signatures in
  // fsig, in index order, and each entry's place in that list in fpos.
  for (int e = tid; e < K; e += FOLD_THREADS) {
    key[e] = __ldg(p.c_filled + e) ? __ldg(p.c_score + e) : -1;
    src[e] = -1;
  }
  if (warp == 0) {
    int nf = 0;
    for (int e0 = 0; e0 < K; e0 += 32) {
      const int e = e0 + lane;
      const bool f = e < K && __ldg(p.c_filled + e) != 0;
      const unsigned b = __ballot_sync(FULL, f);
      if (f) {
        const int q = nf + __popc(b & ((1u << lane) - 1u));
        fsig[q] = (uint32_t)__ldg(p.c_sig + e);
        fpos[e] = q;
      } else if (e < K) {
        fpos[e] = -1;
      }
      nf += __popc(b);
    }
    if (lane == 0) nf_sh = nf;
  }
  __syncthreads();
  int nf = nf_sh;
  unsigned long long best = least_pair(key, K, lane);
  int n_ins = 0;
  int buf = 0;
  for (int lo = 0; lo < W; lo += seg) {
    const int n = min(seg, W - lo);
    if (lo > 0) __syncthreads();  // the last segment's rounds are done
#pragma unroll 4
    for (int i = tid; i < n; i += FOLD_THREADS) {
      const uint8_t m = __ldg(p.mask + lo + i);
      smask[i] = m;
      ssig[i] = m ? (uint32_t)__ldg(p.sigs + lo + i) : 0u;
    }
    __syncthreads();
    for (int i = tid; i < n; i += FOLD_THREADS) {
      if (!smask[i]) {
        p.nov_m[lo + i] = 0;
        p.ins_m[lo + i] = 0;
      }
    }
    int base = 0;
    while (base < n) {
      const int i = base + tid;
      const bool m = i < n && smask[i] != 0;
      int nov = EMPTY_NOVELTY;
      bool novel = false, would = false;
      if (__any_sync(FULL, m)) {
        nov = novelty_of(m ? ssig[i] : 0u, fsig, nf);
        novel = m && nov >= min_novelty;
        would = novel && nov > pair_key(best);
      }
      const unsigned bal = __ballot_sync(FULL, would);
      if (lane == 0) wb[buf][warp] = bal;
      __syncthreads();
      const int f = first_set(wb[buf]);
      buf ^= 1;
      if (m && tid < f) {
        p.nov_m[lo + i] = novel;
        p.ins_m[lo + i] = 0;
      }
      if (f == FOLD_THREADS) {
        base += FOLD_THREADS;
        continue;
      }
      if (tid == f) {
        const int t = pair_index(best);
        int q = fpos[t];
        if (q < 0) {  // an unfilled entry joins the list
          q = nf;
          fpos[t] = q;
          nf_sh = nf + 1;
        }
        fsig[q] = ssig[i];
        key[t] = nov;
        src[t] = lo + i;
        p.nov_m[lo + i] = 1;
        p.ins_m[lo + i] = 1;
      }
      n_ins++;
      __syncthreads();
      nf = nf_sh;
      best = least_pair(key, K, lane);
      base += f + 1;
    }
  }
  __syncthreads();
  for (int e = tid; e < K; e += FOLD_THREADS) {
    const int r = src[e];
    if (r >= 0) {
      p.o_sig[e] = __ldg(p.sigs + r);
      p.o_score[e] = key[e];
      p.o_filled[e] = 1;
      p.o_entry[e] = p.entries ? __ldg(p.entries + r) : -1;
      p.o_depth[e] = p.depths ? __ldg(p.depths + r) : 0;
    } else {
      p.o_sig[e] = __ldg(p.c_sig + e);
      p.o_score[e] = __ldg(p.c_score + e);
      p.o_filled[e] = __ldg(p.c_filled + e);
      p.o_entry[e] = __ldg(p.c_entry + e);
      p.o_depth[e] = __ldg(p.c_depth + e);
    }
  }
  // The schedules as one flat K x row_words copy, each word from the row
  // that last landed in its entry or from the old corpus.
  const int words = K * row_words;
#pragma unroll 4
  for (int x = tid; x < words; x += FOLD_THREADS) {
    const int e = x / row_words;
    const int r = src[e];
    p.o_sched[x] = r >= 0 ? __ldg(p.sched + (size_t)r * row_words +
                                  (x - e * row_words))
                          : __ldg(p.c_sched + x);
  }
  if (tid == 0) {
    *p.n_ins = n_ins;
    *p.o_inserted =
        (int32_t)((uint32_t)__ldg(p.c_inserted) + (uint32_t)n_ins);
  }
}

// The fold's dependent chain alone, a yardstick for its latency: `rounds`
// rounds of corpus_fold_kernel's round (every thread's row scanning
// `filled` staged signatures, the ballot, the barrier, the first inserting
// row), the first `inserts` of them ending in an insert (the shared write,
// the barrier and the (key, index) reduction over K keys), with no
// device-memory traffic. `lo_key` (-1) and `hi_key` (above any novelty)
// come from the caller, so the compiler cannot drop a scan.
__global__ void __launch_bounds__(FOLD_THREADS) fold_chain_kernel(
    int rounds, int inserts, int K, int filled, int lo_key, int hi_key,
    int32_t* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* fsig = reinterpret_cast<uint32_t*>(smem);
  int32_t* key = reinterpret_cast<int32_t*>(fsig + K);
  __shared__ unsigned wb[2][N_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int e = tid; e < K; e += FOLD_THREADS) {
    fsig[e] = (unsigned)e * 0x9E3779B9u;
    key[e] = e;
  }
  __syncthreads();
  unsigned long long best = least_pair(key, K, lane);
  const unsigned s = (unsigned)tid * 0x85EBCA6Bu;
  int buf = 0;
  for (int r = 0; r < rounds; r++) {
    const int nov = novelty_of(s, fsig, filled);
    const bool would = nov > (r < inserts ? lo_key : hi_key);
    const unsigned bal = __ballot_sync(FULL, would);
    if (lane == 0) wb[buf][warp] = bal;
    __syncthreads();
    const int f = first_set(wb[buf]);
    buf ^= 1;
    if (f == FOLD_THREADS) continue;
    if (tid == f) {
      const int t = pair_index(best);
      if (t < filled) fsig[t] = s;
      key[t] = pair_key(best) + K + nov;
    }
    __syncthreads();
    best = least_pair(key, K, lane);
  }
  if (tid == 0) *out = pair_key(best);
}

// An empty launch of the fold's block shape: the launch floor.
__global__ void __launch_bounds__(FOLD_THREADS) fold_empty_kernel() {}

// Lets a kernel take `bytes` of dynamic shared memory where that is above
// the static limit (large K); returns the CUDA status.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)STATIC_SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The fold over W rows out of place: reads the old corpus (K entries,
// c_sched K x row_words int32, c_inserted the insert counter) and the rows
// (sched W x row_words, sigs, mask, entries and depths, which may be null),
// writes the new corpus, the per-row novel and inserted masks and this
// fold's insert count. ptrs holds the N_PTRS pointers in FoldPtrs' order.
// One launch of one block on the given stream; returns its CUDA status.
extern "C" int madsim_corpus_fold(const void* const* ptrs, int n_ptrs,
                                  int K, int row_words, int W,
                                  int min_novelty, void* stream) {
  if (n_ptrs != N_PTRS || K < 1 || K > MAX_K || row_words < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  FoldPtrs p;
  const void** dst = reinterpret_cast<const void**>(&p);
  for (int i = 0; i < N_PTRS; i++) dst[i] = ptrs[i];
  const int seg = W < SEG_ROWS ? (W > 0 ? W : 1) : SEG_ROWS;
  const size_t smem = fold_smem_bytes(K, seg);
  cudaError_t err = allow_smem(corpus_fold_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  corpus_fold_kernel<<<1, FOLD_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      p, K, row_words, W, seg, min_novelty);
  return (int)cudaGetLastError();
}

// The dependent chain of a fold of `rounds` rounds and `inserts` inserts
// over K entries, `filled` of them scanned (see fold_chain_kernel): one
// launch of one block, writing one int to out.
extern "C" int madsim_fold_chain(int rounds, int inserts, int K, int filled,
                                 void* out, void* stream) {
  if (K < 1 || K > MAX_K || rounds < 0 || inserts < 0 || filled < 0 ||
      filled > K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * 8;
  cudaError_t err = allow_smem(fold_chain_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fold_chain_kernel<<<1, FOLD_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      rounds, inserts, K, filled, -1, INT_MAX, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// One empty launch of the fold's block shape on the given stream.
extern "C" int madsim_fold_empty(void* stream) {
  fold_empty_kernel<<<1, FOLD_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
