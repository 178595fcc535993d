"""Coverage-guided fault-schedule search: the closed fuzzer loop.

The PyTorch counterpart of ``madsim_tpu/search``. Retiring worlds' fault
schedules are scored for novelty against a corpus, novel survivors become
parents, and ``sweep(recycle=True, search=SearchConfig(...))`` refills
retired slots with mutated and crossed-over children instead of the fixed
schedule.

- :mod:`.config`: ``SearchConfig``, the static knobs;
- :mod:`.rng`: splitmix64 lanes (counter-based mutation randomness);
- :mod:`.corpus`: the parent corpus and novelty scoring, with its host
  twin;
- :mod:`.mutate`: the splice, disable, jitter, rotate and flip operators;
- :mod:`.generate`: the harvest and generate step;
- :mod:`.family`: ``GuidedPairActor``, the conjunction family with
  observable progress;
- :mod:`.hunts`: the three canonical guided hunts.
"""
import dataclasses as _dc
from typing import Dict as _Dict

import numpy as _np

from .config import SearchConfig
from .corpus import (
    EMPTY_NOVELTY,
    CorpusState,
    HostCorpus,
    corpus_init,
    host_corpus_init,
)
from .family import (
    GuidedPairActor,
    GuidedPairConfig,
    engine_config,
    family_schedule,
)


@_dc.dataclass
class SearchReport:
    """Host-side outcome of one guided sweep (``SweepResult.search``).

    ``schedules`` is the materialized per-seed ``(n, F, 4)`` array of
    the schedule each seed's world ACTUALLY ran (template rows for the
    first batch, generated children after) — the attribution that makes
    a guided find replayable and triageable; it is also installed as
    ``SweepResult.triage_ctx.faults``. The corpus arrays are the final
    device corpus, pulled once at sweep end.

    ``lineage`` / ``operator_stats`` (obs/lineage.py, present when the
    sweep ran ``SearchConfig(lineage=True)``, the default): the
    per-seed provenance lanes — parent corpus-entry ids, applied-
    operator bitmask, ancestry depth — and the per-operator outcome
    table (children produced / novel / survived-to-corpus /
    bug-finding per operator class). ``corpus_entry``/``corpus_depth``
    are the corpus's own lineage lanes, carried through the fleet's
    corpus exchange verbatim so merged reports attribute finds across
    ranges.
    """

    generations: int             # guided-refill generations run
    inserted: int                # total corpus inserts over the sweep
    corpus_size: int             # filled corpus entries at exit
    corpus_capacity: int
    corpus_sched: _np.ndarray    # (K, F, 4) parent schedules
    corpus_sig: _np.ndarray      # (K,) u32 signatures at insert
    corpus_score: _np.ndarray    # (K,) novelty at insert (-0 unfilled)
    corpus_filled: _np.ndarray   # (K,) bool
    schedules: _np.ndarray       # (n, F, 4) per-seed materialized rows
    corpus_entry: _np.ndarray = None   # (K,) i32 lineage entry ids
    corpus_depth: _np.ndarray = None   # (K,) i32 ancestry depth at insert
    lineage: object = None             # obs/lineage.py SearchLineage
    operator_stats: _Dict[str, _Dict[str, int]] = None

    def ancestry(self, seed: int, seeds: _np.ndarray = None):
        """The ancestry chain of ``seed``'s world (a list of nodes back
        to the generation-0 template, obs/lineage.py ``ancestry``).
        ``seeds`` maps positions to seed values; defaults to positions
        == values (the canonical arange hunts)."""
        from ..obs.lineage import ancestry as _ancestry

        if self.lineage is None:
            raise ValueError(
                "this SearchReport carries no lineage (the sweep ran "
                "SearchConfig(lineage=False)) — re-run with lineage=True "
                "(the default) to record provenance lanes")
        if seeds is not None:
            rows = _np.flatnonzero(_np.asarray(seeds) == seed)
            if rows.size == 0:
                raise ValueError(f"seed {seed} was not part of this sweep")
            pos = int(rows[0])
        else:
            pos = int(seed)
        return _ancestry(self.lineage, pos, seeds=seeds)

    def lineage_depth(self) -> int:
        """Deepest ancestry chain materialized by this sweep (0 when
        lineage was off or nothing evolved)."""
        return self.lineage.max_depth if self.lineage is not None else 0

    def summary(self) -> str:
        """Human rendering of the search outcome: corpus fill, insert
        pressure, and the per-operator effectiveness table the future
        credit-assignment scheduler will feed on (docs/search.md
        "Reading the lineage")."""
        from ..obs.lineage import render_operator_table, top_operator

        lines = [f"guided search: corpus {self.corpus_size}/"
                 f"{self.corpus_capacity} filled, {self.inserted} "
                 f"insert(s) over {self.generations} generation(s)"]
        if self.lineage is not None:
            lines[0] += f", max ancestry depth {self.lineage_depth()}"
        if self.operator_stats:
            top = top_operator(self.operator_stats)
            if top:
                lines[0] += f", top operator {top}"
            lines.append(render_operator_table(self.operator_stats))
        return "\n".join(lines)

    def to_json(self) -> _Dict[str, object]:
        """Compact JSON-safe record (bench_results.json ``search``)."""
        out = {
            "generations": int(self.generations),
            "inserted": int(self.inserted),
            "corpus_size": int(self.corpus_size),
            "corpus_capacity": int(self.corpus_capacity),
        }
        if self.operator_stats is not None:
            out["operator_stats"] = self.operator_stats
        if self.lineage is not None:
            out["lineage"] = self.lineage.to_json()
        return out


__all__ = [
    "SearchConfig",
    "SearchReport",
    "CorpusState",
    "HostCorpus",
    "corpus_init",
    "host_corpus_init",
    "EMPTY_NOVELTY",
    "GuidedPairActor",
    "GuidedPairConfig",
    "family_schedule",
    "engine_config",
]
