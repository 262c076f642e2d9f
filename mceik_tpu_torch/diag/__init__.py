"""Online moments (Welford), R-hat and ESS."""
