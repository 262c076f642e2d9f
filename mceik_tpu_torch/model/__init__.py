"""Parameters, data containers and the posterior."""
