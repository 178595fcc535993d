"""The bridge's device decision kernel.

The PyTorch counterpart of ``madsim_tpu/bridge``'s kernel: ``bridge.sweep``
runs unmodified host task bodies over many seeds, and each lockstep round
of timers, cancels, sends, the clock's advance and the due pops runs here
for every world at once (:class:`BridgeKernel`; on CUDA one launch of
``csrc/bridge_step.cu`` a round and one a drain). The drivers that run the
task bodies (JAX's ``bridge/runtime.py`` and ``bridge/pool.py``: ``sweep``,
``sweep_traced``, ``sweep_pooled`` and the rest) belong to the host runtime
and stay outside the port; they drive this kernel through JAX's
signatures.

- :mod:`.kernel`: the types, the plain round and drain, ``BridgeKernel``;
- :mod:`.cuda`: the CUDA kernels' wrapper;
- :mod:`.synthetic`: seeded closed-loop streams of rounds;
- :mod:`.golden`: JAX-derived digests and recorded JAX streams.
"""
from .kernel import BridgeKernel, HostBatch, StepOut

__all__ = ["BridgeKernel", "HostBatch", "StepOut"]
