"""SearchConfig: the knobs of the coverage-guided fault-schedule search.

The port's copy of ``madsim_tpu/search/config.py``: the same fields,
defaults and validation. Frozen and hashable, like ``EngineConfig``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static parameters of the guided-refill schedule generator.

    The mutation percentages select AT MOST one structural mutation per
    schedule row (one draw against their cumulative ranges): disable,
    time jitter, node/param perturbation, or op flip — after the
    two-parent row splice has been applied at ``splice_pct`` per row.
    Rows falling past the cumulative sum are copied unchanged, so a
    child can also be a pure recombination.
    """

    # Corpus capacity: device-resident (K, F, 4) schedules of surviving
    # high-novelty worlds. Small on purpose — the corpus is a parent
    # pool, not an archive (triage/corpus.py owns the failure archive).
    corpus: int = 64
    # The search stream seed (u64). Mutation lanes are a pure function
    # of (seed, slot seed id, generation) — rerunning a hunt with the
    # same SearchConfig reproduces every child bit for bit.
    seed: int = 0x5EED_5EA7_C4
    # Minimum signature sketch distance (bits of the u32 behavior
    # signature, obs/coverage.py) a retiring world must clear against
    # every corpus entry to be inserted. 1 = any unseen signature.
    min_novelty: int = 1
    # Per-row probability (percent) of splicing the row from the second
    # parent before mutation — the two-parent crossover operator.
    splice_pct: int = 25
    # Cumulative per-row mutation distribution (percent of rows drawing
    # each operator; the remainder stays unmutated).
    disable_pct: int = 8
    time_pct: int = 22
    node_pct: int = 25
    op_pct: int = 10
    # Fire-time jitter half-width in virtual µs; 0 derives
    # ``EngineConfig.t_limit_us // 16`` at program-build time.
    time_jitter_us: int = 0
    # False: the corpus never updates past the seeded template — every
    # child is a fresh random mutation of the ORIGINAL schedule. This is
    # the matched random-fuzzing baseline (same operators, same budget,
    # no coverage feedback) that `bench.py guided_hunt` and
    # `make fuzz-demo` compare guided search against.
    guided: bool = True
    # Provenance lanes + per-operator outcome accounting (obs/lineage.py,
    # docs/search.md "Reading the lineage"): every installed child
    # carries its parent corpus-entry ids, applied-operator bitmask and
    # ancestry depth, and the generator accumulates the per-operator
    # produced/novel/survived/bug table — all device-resident,
    # write-only, synced on the cadence the sweep already pays. False
    # compiles every lane out; lineage-on is bitwise identical to
    # lineage-off on trajectories, schedules and corpus.
    lineage: bool = True

    def __post_init__(self):
        if self.corpus < 1:
            raise ValueError("SearchConfig.corpus must be >= 1")
        if self.min_novelty < 1:
            raise ValueError("SearchConfig.min_novelty must be >= 1 "
                             "(0 would admit exact duplicates)")
        for name in ("splice_pct", "disable_pct", "time_pct", "node_pct",
                     "op_pct"):
            v = getattr(self, name)
            if not 0 <= v <= 100:
                raise ValueError(f"SearchConfig.{name} must be in [0, 100]")
        total = (self.disable_pct + self.time_pct + self.node_pct
                 + self.op_pct)
        if total > 100:
            raise ValueError(
                f"SearchConfig mutation percentages are a cumulative "
                f"distribution over one draw per row: disable+time+node+op "
                f"= {total} exceeds 100")
        if self.time_jitter_us < 0:
            raise ValueError("SearchConfig.time_jitter_us must be >= 0")
