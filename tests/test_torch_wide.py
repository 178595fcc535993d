"""The wide lane profile (``EngineConfig(packed=False)``) against the JAX
package on the CPU: the JAX-derived ``observe()`` digests of seeds 0..63
in ``engine/golden.py`` (GOLDEN_WIDE), one deployment of each family that
the CUDA step kernel has a policy for, recomputed from JAX and reproduced
by the port's plain step. ``chip_smoke.py`` holds the kernel's wide
instantiations to the same constants on the card.

Tolerance: none — every operation is integer, or an exactly rounded
float32 product.
"""
import numpy as np
import pytest

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu_torch.engine import golden


@pytest.mark.parametrize("name", sorted(golden.WIDE_CONFIGS))
def test_wide_profile_golden_digests_recomputed_from_jax(name):
    """golden.GOLDEN_WIDE is the JAX package's observe() of each wide
    deployment (``packed=False``), and the port's plain step reproduces
    it on the CPU; chip_smoke.py holds the kernel's wide instantiations to
    the same constants."""
    from madsim_tpu.engine.families import actor_families as j_families
    from madsim_tpu_torch.engine.families import family

    fam, ak, ck, faults, max_steps = golden.wide_config(name)
    fa = None if faults is None else np.asarray(faults, np.int32)
    if fam == "raft":
        ja = J.RaftActor(J.RaftDeviceConfig(**ak))
        ta = T.RaftActor(T.RaftDeviceConfig(**ak))
    else:
        (jcls, jccls), (tcls, tccls) = (j_families()[fam].load(),
                                        family(fam).load())
        ja, ta = jcls(jccls(**ak)), tcls(tccls(**ak))
    je = J.DeviceEngine(ja, J.EngineConfig(**ck))
    te = T.DeviceEngine(ta, T.EngineConfig(**ck), device="cpu")
    jobs = je.observe(je.run(je.init(golden.SEEDS, faults=fa), max_steps))
    assert golden.observe_digest(jobs) == golden.GOLDEN_WIDE[name]
    tobs = te.observe(te.run(te.init(golden.SEEDS, faults=fa), max_steps))
    assert golden.observe_digest(tobs) == golden.GOLDEN_WIDE[name]
    assert all(v.dtype != np.int8 and v.dtype != np.int16
               for v in tobs.values())
