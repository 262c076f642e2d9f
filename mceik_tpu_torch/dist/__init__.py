"""Particle resampling (one device; the collectives are not ported yet)."""
