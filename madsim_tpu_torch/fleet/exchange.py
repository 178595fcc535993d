"""Cross-range corpus exchange: fleet-wide guided search (docs/fleet.md).

Under ``fleet_sweep(search=...)`` each leased seed range evolves its
parent corpus independently — deterministic, but partition-dependent,
and a killed worker forfeits every novel schedule its range discovered.
This module makes the fleet SHARE search progress without giving up one
bit of the chaos contract, by making every exchange decision a pure
function of the range partition and an exchange cadence — never of
scheduling, timing, or failures:

- **Epochs are structural.** Ranges partition into exchange epochs by
  range id (``epoch(r) = r // every``), so which ranges belong to an
  epoch is decided by ``split_ranges`` alone. The epoch BOUNDARY is
  keyed to completed lease quanta: epoch ``e`` ranges become issueable
  only once every epoch ``e-1`` range has published its corpus snapshot
  — never a wall clock.
- **Seeding is deterministic.** A lease for an epoch-``e`` range runs
  its guided sweep from the merged corpus of epoch ``e-1`` (the
  template-seeded corpus for epoch 0), delivered with the lease and
  installed at the sweep's first refill boundary via
  ``sweep(search_corpus=...)`` — a host→device transfer at sweep start,
  zero new mid-loop device syncs. A re-issued lease for a killed
  worker's range seeds from the SAME merged epoch, which is what bounds
  corpus loss to one exchange epoch instead of the whole range.
- **The merge is the device fold's host twin.** Snapshots fold in
  range-id order through :func:`madsim_tpu_torch.search.corpus.merge_corpus`
  — the sequential worst-first insertion of ``harvest_fold``, bit for
  bit (parity tier-1-gated) — so the merged corpus of an epoch is a
  deterministic fold over (previous epoch's corpus, snapshots in
  range-id order), no matter who computed which snapshot or when.
- **Redundancy is an integrity check.** Duplicate publishes (restarted
  workers, re-leased ranges, at-least-once transports) dedupe by range
  id with a bitwise crosscheck — a mismatch raises
  :class:`~madsim_tpu_torch.fleet.merge.FleetIntegrityError`, never a silent
  pick-one. Torn publishes fail the payload checksum, are discarded,
  and the worker re-sends.
- **The merged corpus is durable.** Accepted snapshots persist to
  ``state_path`` (fsync-before-rename, the engine/checkpoint.py
  discipline); a restarted coordinator reloads them and re-derives
  every merged epoch bit-exactly (the merge is a deterministic fold, so
  persistence of the inputs is persistence of the outputs).

Telemetry: every exchange event emits one ``madsim.fleet.exchange/1``
record (publish/merge/broadcast, with epoch, ranges merged, corpus
inserted, bytes) into the same observe sink as the sweep and fleet
schemas; ``python -m madsim_tpu_torch.obs watch`` renders all three
interleaved.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..search.corpus import HostCorpus, host_corpus_init, merge_corpus
from .lease import SeedRange
from .merge import FleetIntegrityError

EXCHANGE_SCHEMA = "madsim.fleet.exchange/1"

# Generation stride between exchange epochs: epoch-``e`` ranges run
# their sweeps with ``search_gen0 = e * GEN_STRIDE``, so each epoch
# draws a FRESH family of mutation streams (children are keyed by
# (search seed, slot id, generation) — without the shift, every range
# would redraw the same mutations its parents' epoch already tried and
# the chained evolution would stall). Epoch 0 stays at 0: its ranges
# are bitwise identical to a non-exchanged fleet's. The stride bounds
# generations per range at 65536 — far above any real refill count.
GEN_STRIDE = 1 << 16

# The exchanged arrays, in canonical wire order (dtype-pinned so the
# checksum is computed over identical bytes on both ends). The
# ``entry``/``depth`` lineage lanes (obs/lineage.py) ride the wire
# verbatim — merged entries keep their origin-range identity, which is
# what lets the fleet-merged report attribute finds across ranges.
_WIRE = (("sched", np.int32), ("sig", np.uint32), ("score", np.int32),
         ("filled", np.bool_), ("entry", np.int32), ("depth", np.int32))


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Knobs of the cross-range corpus exchange.

    ``every`` is the exchange cadence: ranges per epoch (``None`` →
    one epoch per worker-round, i.e. ``n_workers`` at ``fleet_sweep``
    time — epoch peers run in parallel, the barrier sits between
    rounds). A cadence >= the range count means a single epoch: every
    range seeds from the template and the exchange machinery is bitwise
    invisible (tested). ``state_path`` persists accepted snapshots for
    coordinator crash→resume; ``None`` with a fleet ``checkpoint_dir``
    defaults to ``<checkpoint_dir>/exchange_state.npz``.
    """

    every: Optional[int] = None
    state_path: Optional[str] = None

    def __post_init__(self):
        if self.every is not None and self.every < 1:
            raise ValueError("ExchangeConfig.every must be >= 1")


def corpus_payload(corpus: HostCorpus) -> Dict[str, Any]:
    """Serialize a corpus snapshot for the RPC wire: the four arrays
    (dtype-pinned) plus a sha256 over their canonical bytes — the
    torn-publish detector."""
    out: Dict[str, Any] = {}
    h = hashlib.sha256()
    for name, dt in _WIRE:
        arr = np.ascontiguousarray(np.asarray(getattr(corpus, name), dt))
        out[name] = arr
        h.update(arr.tobytes())
    out["sha256"] = h.hexdigest()
    return out


def payload_bytes(payload: Dict[str, Any]) -> int:
    """Wire size of a snapshot payload (telemetry)."""
    return int(sum(np.asarray(payload[name]).nbytes for name, _ in _WIRE))


class TornPayloadError(ValueError):
    """A corpus payload failed validation (missing/mis-shaped arrays or
    checksum mismatch): the transfer tore in flight. Recoverable — the
    receiver discards it and the sender re-sends."""


def payload_corpus(payload: Any, corpus_k: Optional[int] = None,
                   f_rows: Optional[int] = None) -> HostCorpus:
    """Validate + deserialize a snapshot payload; raises
    :class:`TornPayloadError` on any malformation, so a torn publish is
    discarded at the boundary instead of corrupting the merge fold."""
    if not isinstance(payload, dict):
        raise TornPayloadError(
            f"corpus payload must be a dict, got {type(payload).__name__}")
    arrs = {}
    h = hashlib.sha256()
    for name, dt in _WIRE:
        if name not in payload:
            raise TornPayloadError(f"corpus payload missing {name!r}")
        arr = np.ascontiguousarray(np.asarray(payload[name], dt))
        arrs[name] = arr
        h.update(arr.tobytes())
    sched, sig = arrs["sched"], arrs["sig"]
    if sched.ndim != 3 or sched.shape[-1] != 4:
        raise TornPayloadError(
            f"corpus sched must be (K, F, 4), got {sched.shape}")
    k = sched.shape[0]
    if corpus_k is not None and k != corpus_k:
        raise TornPayloadError(
            f"corpus payload holds {k} entries but SearchConfig.corpus "
            f"is {corpus_k} — all workers must run one SearchConfig")
    if f_rows is not None and sched.shape[1] != f_rows:
        raise TornPayloadError(
            f"corpus schedules carry {sched.shape[1]} rows but the fleet "
            f"template has {f_rows}")
    for name in ("sig", "score", "filled", "entry", "depth"):
        if arrs[name].shape != (k,):
            raise TornPayloadError(
                f"corpus {name} must be ({k},), got {arrs[name].shape}")
    if payload.get("sha256") != h.hexdigest():
        raise TornPayloadError(
            "corpus payload checksum mismatch (torn publish): "
            f"recorded {str(payload.get('sha256'))[:16]}..., recomputed "
            f"{h.hexdigest()[:16]}...")
    return HostCorpus(sched=sched, sig=sig, score=arrs["score"],
                      filled=arrs["filled"], entry=arrs["entry"],
                      depth=arrs["depth"])


def _snapshots_equal(a: HostCorpus, b: HostCorpus) -> List[str]:
    """Field names where two snapshots of the SAME range disagree
    bitwise (empty = interchangeable) — the dedupe crosscheck."""
    return [name for name, dt in _WIRE
            if not np.array_equal(np.asarray(getattr(a, name), dt),
                                  np.asarray(getattr(b, name), dt))]


class CorpusExchange:
    """Coordinator-side exchange state: published snapshots, the epoch
    barrier, and the merged-corpus chain.

    Pure host bookkeeping, deterministic by construction: its outputs
    (eligibility, seed corpora, merged epochs) depend only on WHICH
    ranges have published — never on order of arrival, duplicates, or
    the clock — which is what lets the chaos matrix hold bitwise.
    """

    def __init__(self, ranges: Sequence[SeedRange], every: int,
                 template: np.ndarray, corpus_k: int, min_novelty: int,
                 emit=None, clock=None, state_path: Optional[str] = None):
        if every < 1:
            raise ValueError("exchange cadence (every) must be >= 1")
        self.range_ids = sorted(r.range_id for r in ranges)
        if self.range_ids != list(range(len(self.range_ids))):
            raise ValueError("exchange needs the contiguous range ids of "
                             "split_ranges")
        self.every = int(every)
        self.n_ranges = len(self.range_ids)
        self.n_epochs = -(-self.n_ranges // self.every)
        self.template = np.asarray(template, np.int32)
        self.corpus_k = int(corpus_k)
        self.min_novelty = int(min_novelty)
        self.state_path = state_path
        self._emit = emit
        self._clock = clock
        self.base = host_corpus_init(self.corpus_k, self.template)
        self._published: Dict[int, HostCorpus] = {}
        self._merged: Dict[int, HostCorpus] = {}
        self.stats: Dict[str, int] = {
            "exchange_epochs": self.n_epochs,
            "publishes": 0,
            "publishes_duplicate": 0,
            "publishes_torn": 0,
            "epochs_merged": 0,
            "merge_inserts": 0,
            "broadcast_bytes": 0,
            "publish_bytes": 0,
        }

    # -- telemetry -------------------------------------------------------
    def emit(self, event: str, **fields) -> None:
        if self._emit is None:
            return
        rec = {"schema": EXCHANGE_SCHEMA, "event": event,
               "t": self._clock.now() if self._clock is not None else 0.0}
        rec.update(fields)
        self._emit(rec)

    # -- the epoch partition (pure functions of the range split) ---------
    def epoch_of(self, range_id: int) -> int:
        return range_id // self.every

    def gen0_of(self, range_id: int) -> int:
        """The sweep's ``search_gen0`` for this range: the epoch stream
        offset (:data:`GEN_STRIDE`), a pure function of the range id —
        a re-issued lease draws the identical streams."""
        return self.epoch_of(range_id) * GEN_STRIDE

    def epoch_ranges(self, epoch: int) -> List[int]:
        return [rid for rid in self.range_ids if self.epoch_of(rid) == epoch]

    def merged_through(self) -> int:
        """Number of consecutively merged epochs from 0 — the exchange
        frontier. Epoch ``e`` ranges are issueable iff ``e <= frontier``."""
        e = 0
        while e in self._merged:
            e += 1
        return e

    def eligible(self, range_id: int) -> bool:
        """May this range be leased yet? Its epoch's seed corpus must
        exist — i.e. every earlier epoch has merged. (The barrier that
        keys epoch boundaries to completed lease quanta.)"""
        return self.epoch_of(range_id) <= self.merged_through()

    def blocked_reason(self, range_id: int) -> Optional[str]:
        """Human diagnosis for a pending-but-ineligible range (the
        FleetStalledError detail)."""
        e = self.epoch_of(range_id)
        if e <= self.merged_through():
            return None
        waiting = [rid for rid in self.epoch_ranges(self.merged_through())
                   if rid not in self._published]
        return (f"blocked at exchange barrier: epoch {e} awaits the "
                f"merge of epoch {self.merged_through()} "
                f"(unpublished ranges: {waiting})")

    # -- seeding ---------------------------------------------------------
    def seed_corpus(self, range_id: int) -> Optional[HostCorpus]:
        """The corpus an epoch-``e`` range's sweep starts from: the
        merged epoch ``e-1`` corpus, or ``None`` for epoch 0 (the sweep
        falls back to its own template-seeded ``corpus_init`` — the
        exact non-exchanged behavior)."""
        e = self.epoch_of(range_id)
        if e == 0:
            return None
        merged = self._merged.get(e - 1)
        if merged is None:
            raise FleetIntegrityError(
                f"range {range_id} (epoch {e}) was leased before epoch "
                f"{e - 1} merged — the exchange barrier was bypassed")
        return merged

    def seed_payload(self, range_id: int, worker: str = "?"
                     ) -> Optional[Dict[str, Any]]:
        """Wire payload of :meth:`seed_corpus` (+ broadcast telemetry)."""
        corpus = self.seed_corpus(range_id)
        if corpus is None:
            return None
        payload = corpus_payload(corpus)
        n = payload_bytes(payload)
        self.stats["broadcast_bytes"] += n
        self.emit("broadcast", worker=worker, range_id=range_id,
                  epoch=self.epoch_of(range_id),
                  from_epoch=self.epoch_of(range_id) - 1, bytes=n)
        return payload

    # -- publish / dedupe / merge ----------------------------------------
    def has(self, range_id: int) -> bool:
        return range_id in self._published

    def publish(self, range_id: int, payload: Any,
                worker: str = "?") -> Dict[str, Any]:
        """Accept one range's corpus snapshot.

        Torn payloads (checksum/shape failures) are discarded with
        ``{"accepted": False, "torn": True}`` — the sender re-sends.
        Duplicates (same range published again — a restarted worker, a
        re-leased range's second holder, a retransmission) crosscheck
        bitwise against the accepted snapshot: equal → absorbed,
        different → :class:`FleetIntegrityError` (the determinism
        contract is broken; never silently pick one).
        """
        if range_id not in set(self.range_ids):
            raise FleetIntegrityError(
                f"publish for unknown range {range_id} "
                f"(fleet has ranges {self.range_ids[:4]}...)")
        try:
            corpus = payload_corpus(payload, corpus_k=self.corpus_k,
                                    f_rows=self.template.shape[0])
        except TornPayloadError as exc:
            self.stats["publishes_torn"] += 1
            self.emit("publish_torn", worker=worker, range_id=range_id,
                      epoch=self.epoch_of(range_id), error=str(exc))
            return {"accepted": False, "torn": True, "error": str(exc)}
        if range_id in self._published:
            bad = _snapshots_equal(self._published[range_id], corpus)
            if bad:
                raise FleetIntegrityError(
                    f"duplicate corpus publish for range {range_id} "
                    f"(epoch {self.epoch_of(range_id)}) disagrees with "
                    f"the accepted snapshot on: {', '.join(bad)} — two "
                    "executions of one range must be bitwise identical; "
                    "this fleet is mixing engine/search versions or "
                    "running nondeterministic code")
            self.stats["publishes_duplicate"] += 1
            self.emit("publish", worker=worker, range_id=range_id,
                      epoch=self.epoch_of(range_id), duplicate=True,
                      bytes=payload_bytes(payload))
            return {"accepted": True, "torn": False, "duplicate": True}
        self._published[range_id] = corpus
        self.stats["publishes"] += 1
        self.stats["publish_bytes"] += payload_bytes(payload)
        self.emit("publish", worker=worker, range_id=range_id,
                  epoch=self.epoch_of(range_id), duplicate=False,
                  bytes=payload_bytes(payload),
                  corpus_size=int(np.asarray(corpus.filled).sum()))
        self._try_merge()
        if self.state_path is not None:
            self._save(self.state_path)
        return {"accepted": True, "torn": False, "duplicate": False}

    def _try_merge(self) -> None:
        """Merge every epoch whose ranges have all published, in epoch
        order — a fold whose inputs (snapshots, order) are independent
        of scheduling, so the chain is reproducible from the published
        set alone."""
        e = self.merged_through()
        while e < self.n_epochs:
            rids = self.epoch_ranges(e)
            if not all(rid in self._published for rid in rids):
                return
            acc = self.base if e == 0 else self._merged[e - 1]
            inserts = 0
            for rid in rids:                 # range-id order: the contract
                acc, n = merge_corpus(acc, self._published[rid],
                                      self.min_novelty)
                inserts += n
            self._merged[e] = acc
            self.stats["epochs_merged"] += 1
            self.stats["merge_inserts"] += inserts
            self.emit("merge", epoch=e, ranges_merged=len(rids),
                      corpus_inserted=inserts,
                      corpus_size=int(np.asarray(acc.filled).sum()),
                      corpus_gen=e + 1,
                      epochs_merged=self.stats["epochs_merged"])
            e += 1

    def merged_epoch(self, epoch: int) -> HostCorpus:
        if epoch not in self._merged:
            raise FleetIntegrityError(
                f"exchange epoch {epoch} has not merged "
                f"(frontier: {self.merged_through()})")
        return self._merged[epoch]

    # -- the fleet-level search report -----------------------------------
    def fleet_report(self, n_seeds: int, ranges: Sequence[SeedRange],
                     parts: Dict[int, Any]):
        """Assemble the merged ``SweepResult.search``: the final merged
        corpus (the last epoch's fold) plus the per-seed materialized
        schedules — and the per-seed lineage lanes + summed operator
        outcome table (obs/lineage.py) — scattered from the per-range
        reports. Each range wrote its lineage entry ids at base
        ``range.lo``, so the concatenated per-seed arrays resolve
        cross-range ancestry at ``entry_base=0`` with plain arithmetic.
        """
        from ..obs.lineage import SearchLineage, merge_operator_stats
        from ..search import SearchReport

        final = self.merged_epoch(self.n_epochs - 1)
        f = self.template.shape[0]
        sched = np.full((n_seeds, f, 4), -1, np.int32)
        sched[:, :, 1:] = 0                  # canonical DISABLED_ROW pad
        lin_arrays = {
            "parent1": np.full((n_seeds,), -1, np.int32),
            "parent2": np.full((n_seeds,), -1, np.int32),
            "ops": np.zeros((n_seeds,), np.int32),
            "depth": np.zeros((n_seeds,), np.int32),
        }
        op_parts = []
        lineage_all = True
        generations = inserted = 0
        for r in sorted(ranges, key=lambda r: r.range_id):
            rep = getattr(parts[r.range_id], "search", None)
            if rep is None:
                raise FleetIntegrityError(
                    f"range {r.range_id} completed without a search "
                    "report under an exchanged fleet — all workers must "
                    "run search=")
            sched[r.lo:r.hi] = np.asarray(rep.schedules,
                                          np.int32)[:r.n_seeds]
            generations += int(rep.generations)
            inserted += int(rep.inserted)
            lin = getattr(rep, "lineage", None)
            if lin is None:
                lineage_all = False
            else:
                for name in lin_arrays:
                    lin_arrays[name][r.lo:r.hi] = np.asarray(
                        getattr(lin, name), np.int32)[:r.n_seeds]
                op_parts.append(rep.operator_stats or {})
        filled = np.asarray(final.filled, bool)
        lineage = (SearchLineage(entry_base=0, **lin_arrays)
                   if lineage_all else None)
        return SearchReport(
            generations=generations, inserted=inserted,
            corpus_size=int(filled.sum()), corpus_capacity=int(self.corpus_k),
            corpus_sched=np.asarray(final.sched, np.int32),
            corpus_sig=np.asarray(final.sig, np.uint32),
            corpus_score=np.asarray(final.score, np.int32),
            corpus_filled=filled, schedules=sched,
            corpus_entry=np.asarray(final.entry, np.int32),
            corpus_depth=np.asarray(final.depth, np.int32),
            lineage=lineage,
            operator_stats=(merge_operator_stats(op_parts)
                            if lineage_all and op_parts else None))

    # -- persistence (the coordinator's crash→resume aux channel) --------
    def _save(self, path: str) -> None:
        """Persist accepted snapshots atomically (tmp + fsync + rename,
        the engine/checkpoint.py discipline). Merged epochs are NOT
        stored: the merge is a deterministic fold of the stored inputs,
        so a resume re-derives them bit-exactly — persistence of the
        inputs IS persistence of the outputs."""
        arrays: Dict[str, np.ndarray] = {
            "meta": np.array([self.n_ranges, self.every, self.corpus_k,
                              self.min_novelty], np.int64),
            "template": self.template,
            "published": np.array(sorted(self._published), np.int64),
        }
        for rid, c in self._published.items():
            for name, dt in _WIRE:
                arrays[f"r{rid}_{name}"] = np.asarray(getattr(c, name), dt)
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".exchange.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def resume(self, path: str) -> int:
        """Reload accepted snapshots from :meth:`_save` output and
        re-derive the merged-epoch chain. Returns the number of
        snapshots restored. A mismatched fleet shape (different range
        count, cadence, corpus size, novelty bar, or template) raises
        :class:`FleetIntegrityError` — resuming an exchange under a
        different partition would seed ranges with corpora they never
        would have seen."""
        with np.load(path, allow_pickle=False) as z:
            meta = np.asarray(z["meta"], np.int64)
            want = np.array([self.n_ranges, self.every, self.corpus_k,
                             self.min_novelty], np.int64)
            if meta.shape != want.shape or not np.array_equal(meta, want):
                raise FleetIntegrityError(
                    f"exchange state {path!r} was written by a different "
                    f"fleet shape (n_ranges/every/corpus/min_novelty "
                    f"{meta.tolist()} vs {want.tolist()}): results are "
                    "deterministic per partitioning + cadence — resume "
                    "with the original settings or delete the state file")
            if not np.array_equal(np.asarray(z["template"], np.int32),
                                  self.template):
                raise FleetIntegrityError(
                    f"exchange state {path!r} holds a different fault "
                    "template — this state belongs to another hunt")
            for rid in np.asarray(z["published"], np.int64).tolist():
                self._published[int(rid)] = HostCorpus(
                    **{name: np.asarray(z[f"r{rid}_{name}"], dt)
                       for name, dt in _WIRE})
        restored = len(self._published)
        self._try_merge()
        self.emit("resume", snapshots=restored,
                  epochs_merged=self.merged_through())
        return restored


__all__ = [
    "EXCHANGE_SCHEMA", "GEN_STRIDE", "CorpusExchange", "ExchangeConfig",
    "TornPayloadError", "corpus_payload", "payload_bytes",
    "payload_corpus",
]
