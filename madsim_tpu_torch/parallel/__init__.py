"""Seed sweeps over the port's batched engine."""
