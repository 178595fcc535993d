"""madsim_tpu_torch — the PyTorch and CUDA port of madsim_tpu's batched
device engine.

A package of its own beside ``madsim_tpu`` (the JAX reference): it imports
``torch`` and ``numpy`` and nothing of JAX or of ``madsim_tpu``. Each module
mirrors the JAX module of the same name and reproduces its results bit for
bit; the engine's step runs on an NVIDIA GPU as one hand-written CUDA kernel
(``csrc/step_kernel.cuh``, with a policy per actor family), built with
``nvcc`` at first use.

Usage::

    from madsim_tpu_torch.engine import (DeviceEngine, EngineConfig,
                                         RaftActor, RaftDeviceConfig)
    eng = DeviceEngine(RaftActor(RaftDeviceConfig(n=3)),
                       EngineConfig(n_nodes=3))       # device="cuda"
    state = eng.run(eng.init(range(4096)), max_steps=2_000)
    obs = eng.observe(state)
"""

__version__ = "0.1.0"
