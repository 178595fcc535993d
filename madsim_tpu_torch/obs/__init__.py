"""Observability of the port: the metrics block and the flight recorder
written inside the step, the sweep's behavior-coverage ledger, timelines,
repro bundles and the sweep observatory.

The PyTorch counterparts of ``madsim_tpu/obs``:

1. **Counters** (:mod:`.metrics`): the opt-in ``MetricsBlock`` carried
   beside ``WorldState`` (``EngineConfig(metrics=True)``), written in the
   step; and the flight recorder (:mod:`.blackbox`,
   ``EngineConfig(blackbox=K)``).
2. **Traces** (:mod:`.timeline`): ``DeviceEngine.trace()`` output and
   decoded rings rendered as Chrome trace-event JSON or text, in virtual
   time.
3. **One-file repros** (:mod:`.bundle`): a failing seed's whole recipe,
   which ``python -m madsim_tpu_torch.obs replay --bundle`` re-runs.
4. **The sweep observatory**: the behavior-coverage ledger folded on the
   device (:mod:`.coverage`), and the telemetry stream, Prometheus
   snapshots and ``torch.profiler`` windows of :mod:`.observatory`
   (``sweep(observe=..., profile_dir=...)``), with the ``watch`` CLI.

CLI: ``python -m madsim_tpu_torch.obs replay|lineage|watch`` (obs/cli.py).
"""
from .blackbox import (
    BlackboxRing,
    blackbox_block,
    decode_ring,
    ring_matches_trace,
    rings_from_observations,
)
from .bundle import load_bundle, write_sweep_bundle
from .coverage import (
    DEFAULT_BUCKETS,
    SweepCoverage,
    behavior_signature,
    coverage_of_counters,
)
from .metrics import (
    BLOCK_FIELDS,
    NUM_FAULT_KINDS,
    MetricsBlock,
    aggregate_metrics,
    metrics_from_observations,
)
from .observatory import (
    JsonlEmitter,
    ProfilerWindow,
    make_observer,
    prometheus_text,
    write_prometheus,
)
from .timeline import polls_to_chrome, render_text, ring_to_chrome, \
    trace_to_chrome

__all__ = [
    "BlackboxRing", "blackbox_block", "decode_ring",
    "ring_matches_trace", "rings_from_observations", "ring_to_chrome",
    "MetricsBlock", "NUM_FAULT_KINDS", "BLOCK_FIELDS",
    "aggregate_metrics", "metrics_from_observations",
    "SweepCoverage", "DEFAULT_BUCKETS", "behavior_signature",
    "coverage_of_counters",
    "JsonlEmitter", "ProfilerWindow", "make_observer",
    "prometheus_text", "write_prometheus",
    "trace_to_chrome", "polls_to_chrome", "render_text",
    "write_sweep_bundle", "load_bundle",
]
