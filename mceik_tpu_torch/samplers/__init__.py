"""MCMC runner and samplers: random-walk Metropolis, adaptive Metropolis
(diagonal and full covariance), preconditioned MALA, and tempered SMC."""
