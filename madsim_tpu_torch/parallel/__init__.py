"""Seed sweeps over the port's batched engine.

The port of ``madsim_tpu.parallel`` on one device: :func:`sweep`, its
:class:`SweepResult`, and the fleet worker's :class:`SweepSession`. The
module itself is ``madsim_tpu_torch.parallel.sweep`` (import it with
``importlib.import_module``: this package's ``sweep`` is the function, as
in the JAX package).
"""
from .sweep import SweepResult, SweepSession, sweep

__all__ = ["sweep", "SweepResult", "SweepSession"]
