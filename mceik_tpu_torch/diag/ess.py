"""Convergence diagnostics: split R-hat and autocorrelation ESS.

A copy of ``mceik_tpu/diag/ess.py``, which is numpy already. Host-side
post-processing of thinned sample traces with shape
``(n_draws, n_chains, ...)``. Standard definitions (Gelman et al., BDA3 /
Geyer initial-positive-sequence truncation), used both by tests and by the
effective-samples/s north-star metric (SURVEY.md §6).
"""

from __future__ import annotations

import numpy as np


def split_rhat(x: np.ndarray) -> np.ndarray:
    """Split R-hat. x: (n_draws, n_chains, ...) -> (...)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0] // 2 * 2
    x = x[:n]
    halves = np.concatenate([x[: n // 2], x[n // 2:]], axis=1)  # (n/2, 2C, ...)
    m = halves.shape[1]
    nn = halves.shape[0]
    chain_mean = halves.mean(axis=0)
    chain_var = halves.var(axis=0, ddof=1)
    B = nn * chain_mean.var(axis=0, ddof=1)
    W = chain_var.mean(axis=0)
    var_plus = (nn - 1) / nn * W + B / nn
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_plus / W)
    return out


def _autocov(x: np.ndarray) -> np.ndarray:
    """FFT autocovariance per chain. x: (n, C) -> (n, C)."""
    n = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].real
    return acov / n


def ess(x: np.ndarray) -> float:
    """Multi-chain effective sample size of a scalar trace (n_draws, n_chains).

    Uses between/within-chain pooled autocorrelation with Geyer
    initial-monotone truncation (matches Stan's definition closely enough
    for throughput metrics and tests)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, m = x.shape
    if n < 4:
        return float(n * m)
    acov = _autocov(x)  # (n, C)
    chain_mean = x.mean(axis=0)
    mean_var = acov[0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += chain_mean.var(ddof=1)
    if var_plus <= 0 or not np.isfinite(var_plus):
        return float(n * m)

    rho = 1.0 - (mean_var - acov.mean(axis=1)) / var_plus  # (n,)
    rho[0] = 1.0
    # Geyer: sum consecutive pairs while positive & monotone decreasing.
    t = 1
    tau = 1.0
    prev_pair = np.inf
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        prev_pair = pair
        tau += 2.0 * pair
        t += 2
    return float(n * m / max(tau, 1e-12))


def ess_per_param(x: np.ndarray) -> np.ndarray:
    """Per-parameter ESS. x: (n_draws, n_chains, ...) -> (...).

    The north-star quantity is posterior-moment accuracy of the *tracked
    fields* (slowness cells, hypocenters), so ESS of the scalar logpost
    alone flatters mixing; min/median over this array is what the
    moments criterion actually feels (VERDICT r1 weak #6).
    """
    x = np.asarray(x, dtype=np.float64)
    n, m = x.shape[:2]
    flat = x.reshape(n, m, -1)
    out = np.asarray([ess(flat[:, :, k]) for k in range(flat.shape[2])])
    return out.reshape(x.shape[2:])
