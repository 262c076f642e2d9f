"""MCMC runner and samplers: adaptive Metropolis (diagonal and full
covariance) and preconditioned MALA."""
