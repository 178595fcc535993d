"""Spec-defined protocol families: the port's copies of
``madsim_tpu.actorc.families`` — ``tpc`` and ``pb`` (migrated from
hand-written actors in the JAX package) and ``paxos`` (the first DSL-only
family). The raft actor stays hand-written in
:mod:`madsim_tpu_torch.engine.raft_actor`.
"""
