"""MCMC runner and samplers (adaptive Metropolis so far)."""
