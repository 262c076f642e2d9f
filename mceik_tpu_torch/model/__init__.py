"""Parameters, data containers, the posterior and the Laplace fit."""
