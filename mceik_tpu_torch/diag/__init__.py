"""Online moments (Welford), R-hat and ESS; the device profile, the
golden-run harness and the on-card sanity check."""
