"""Observability of the port: the metrics block and the flight recorder
written inside the step, and the sweep's behavior-coverage ledger.

The PyTorch counterparts of ``madsim_tpu/obs/{metrics,blackbox,coverage}``.
"""
