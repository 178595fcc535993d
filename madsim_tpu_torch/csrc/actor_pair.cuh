// The pair-restart policy of the engine's CUDA step kernel
// (step_kernel.cuh), for both pair families, written by hand from their
// actors: madsim_tpu/triage/synthetic.py PairRestartActor and
// madsim_tpu/search/family.py GuidedPairActor (the plain versions:
// madsim_tpu_torch/triage/synthetic.py, search/family.py, on step_plain).
//
// The state is one int32 restart counter per node. The handler does
// nothing (the seed message and the beacons are only delivered). A restart
// of node a reads restarts[a] (the index clamped into range) and writes
// restarts[a] + 1 (nothing when a is out of range, int32 add). The invariant
// is restarts[node_a] > 0 && restarts[node_b] > 0.
//
// The outbox is the actors' two rows (M = 2, so the step draws four
// times): row 0 the progress beacon, row 1 never used. With the beacon on
// (GuidedPairActor; a family parameter), the first restart of node_a or
// node_b sends row 0: kind 1 to node 0, words all 0. As a message to node
// 0 it is entry 0 of the sends, at the latency counter ctr + 0 and the
// loss counter ctr + 1, which are row 0's; it takes the first free slot.
// The pair families run up to 12 nodes (the guided hunt's), the only
// policy instantiated past 8.
#pragma once

#include "step_common.cuh"

namespace {

constexpr int PAIR_BEACON_KIND = 1;

template <class Pf>
struct PairLanes {
  using Profile = Pf;
  int32_t* restarts;  // (W, N), int32 in both profiles
};

// Params::f0..f2 (step_kernel.py kernel_params): node_a, node_b, beacon.
template <int N>
struct PairView {
  int32_t* restarts;
  int a, b;

  template <class Lanes>
  __device__ __forceinline__ PairView(const Lanes& l, size_t w,
                                      const Params& p)
      : restarts(l.restarts + w * N), a(p.f0), b(p.f1) {}
};

struct PairRow {};

template <class Pf>
struct PairP {
  using Lanes = PairLanes<Pf>;
  template <int N>
  using View = PairView<N>;
  using Row = PairRow;
  static constexpr int FAMILY = FAMILY_PAIR;
  // Node counts up to 12; the outbox is the beacon row and a spare row.
  static constexpr int MAX_NODES = 12;
  __host__ __device__ static constexpr int m(int) { return 2; }
  // Payload rows of at least 8 words.
  static constexpr bool SHORT_PAYLOAD = false;

  template <int N>
  static __device__ __forceinline__ void tiles_in(const State<Lanes>&,
                                                  const Params&, char*,
                                                  size_t, int, int, int,
                                                  int) {}

  template <int N>
  static __device__ __forceinline__ PairView<N> view(const State<Lanes>& s,
                                                     const Params& p,
                                                     size_t w, char*, int) {
    return PairView<N>(s.a, w, p);
  }

  template <int N>
  static __device__ __forceinline__ int frozen_hint(const State<Lanes>&,
                                                    size_t) {
    return 0;
  }
  template <int N>
  static __device__ __forceinline__ bool frozen_bug(const State<Lanes>& s,
                                                    const Params& p, size_t w,
                                                    int) {
    return invariant<N>(PairView<N>(s.a, w, p));
  }

  template <int N>
  static __device__ __forceinline__ PairRow load_row(const PairView<N>&,
                                                     int) {
    return PairRow{};
  }

  // on_restart: count the restart; the guided family's beacon on a
  // target's first restart. No draw.
  template <int N>
  static __device__ __forceinline__ void on_restart(const Params& p,
                                                    const PairView<N>& v,
                                                    int node, uint32_t,
                                                    uint32_t, uint32_t&,
                                                    Sends& sd) {
    const int32_t prev = v.restarts[clampi(node, 0, N - 1)];
    if (node >= 0 && node < N)
      v.restarts[node] = (int32_t)((uint32_t)prev + 1u);
    if (p.f2 && (node == v.a || node == v.b) && prev == 0) {
      sd.msg_mask = 1u;
      sd.msg_kind = PAIR_BEACON_KIND;
    }
  }

  template <int N>
  static __device__ __forceinline__ void handle(
      const Params&, const PairView<N>&, int, int, const Payload,
      const PairRow, int32_t, uint32_t, uint32_t, uint32_t&, Sends&,
      bool& hbug) {
    hbug = false;
  }

  template <int N>
  static __device__ __forceinline__ bool invariant(const PairView<N>& v) {
    return v.restarts[v.a] > 0 && v.restarts[v.b] > 0;
  }

  template <int N>
  static __device__ __forceinline__ Payload message(const Params&,
                                                    const PairView<N>&,
                                                    const Sends& sd, int) {
    return plain_message(sd);
  }

  // No pair timer draws its delay.
  static __device__ __forceinline__ int32_t draw_delay(const Params&,
                                                       uint32_t) {
    return 0;
  }

  // No tiles of its own; both targets are nodes of the world.
  static bool params_ok(const Params& p) {
    return p.N >= 1 && p.f0 >= 0 && p.f0 < p.N && p.f1 >= 0 &&
           p.f1 < p.N && (p.f2 == 0 || p.f2 == 1) && p.commit_stride == 0 &&
           p.log_stride == 0 && p.commit_unit == 0 && p.log_unit == 0;
  }
};
using Pair = PairP<PackedProfile>;
using PairWide = PairP<WideProfile>;

}  // namespace
