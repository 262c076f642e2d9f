"""Particle resampling (one device; the collectives are slice 7)."""
