"""Failure triage, as far as the port goes: the synthetic pair-restart
actor (:mod:`.synthetic`). Schedule minimisation and the deduplicated
corpus are not ported (ROADMAP)."""
