"""On-card sanity check and dependency-chained timing of every batched
eikonal and transport route of the port.

    python -m mceik_tpu_torch.diag.sanity

Counterpart of ``tools/tpu_sanity.py``, on the card only (it refuses to run
without one). The medium is the reference's: a 64^3 grid, ``s = exp(0.2 u)``
with ``u`` a 6^3 standard-normal field (numpy's draw) upsampled linearly,
and 8 sources uniform in [5, 59]^3 (``RandomState(0)``), solved for 8
chained copies of the slowness, 64 fields per call. Each forward route's
batch is held to a tight plain solve on the card (tol 1e-5, ``max_iters``
60) at the reference's bar, max error < 5e-2: ``"xla"`` (the plain cycle),
``"field"`` and ``"blocked"`` (K1, one and two cycles per iteration),
``"gridbatch"`` (K1), the Jacobi solve (plain, tol 1e-3, ``max_iters``
400), and a 2-D batch of the same make (64^2, 8 x 8 fields) through K3's
warp and block routes forced. Every transport route is held to the plain
transport solve of the same cotangents and weights (bar: 1e-5 of max |λ|):
K4 and K5 forced on the 3-D batch, K6 on the 2-D one.

Each call's input depends on the previous call's output (``s * (1 + 1e-7
mean(T))``), so nothing is reused or overlapped; the time is the mean of 3
such calls after one more (ms per batch, host clock around synchronised
calls). Prints one OK/BAD row per route with its first call's kernel
launches (a row is BAD too if it did not launch exactly its kernels: none
for the plain routes and the Jacobi solve), and exits non-zero if any row
is BAD.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch

from mceik_tpu_torch.eikonal import cuda_sweep, cuda_transport
from mceik_tpu_torch.eikonal.adjoint_sweep import (batch_weights,
                                                   transport_cycle_plain,
                                                   transport_solve)
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_source,
                                           source_scalars)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import slowness_from_u

BAR = 5e-2            # forward routes: max |T - T_ref| (the reference's)
TRANSPORT_BAR = 1e-5  # transport routes: max |lam - lam_plain| / max |lam|
N_CHAINED = 8         # slowness copies per call (x 8 sources = 64 fields)
N_TIMED = 3


def medium(ndim: int, device):
    """The reference's medium in ``ndim`` dimensions: the grid (64 nodes a
    side), the slowness and the 8 sources."""
    grid = Grid((64,) * ndim, (1.0,) * ndim)
    u = np.random.default_rng(0).standard_normal((6,) * ndim)
    s = slowness_from_u(torch.tensor(0.2 * u, dtype=torch.float32,
                                     device=device), grid,
                        torch.tensor(1.0, device=device))
    srcs = np.random.RandomState(0).uniform(5, 59, (8, ndim))
    return grid, s, torch.tensor(srcs, dtype=torch.float32, device=device)


def _flat(s_c, srcs):
    """``(C,) + grid`` slownesses and ``(S, D)`` sources -> the ``C x S``
    flat batch."""
    C, S = s_c.shape[0], srcs.shape[0]
    s_b = s_c.unsqueeze(1).expand((C, S) + tuple(s_c.shape[1:]))
    return (s_b.reshape((C * S,) + tuple(s_c.shape[1:])).contiguous(),
            srcs.repeat(C, 1))


def _chained(f, s8):
    """(first output, ms per call): one call, then ``N_TIMED`` calls each
    on a slowness that depends on the previous output."""
    from mceik_tpu_torch.diag.profile import counts

    c0 = counts()
    out = f(s8)
    torch.cuda.synchronize()
    launched = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
    acc = s8
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        T = f(acc)
        acc = s8 * (1.0 + 1e-7 * T.mean())
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / N_TIMED * 1e3, launched


def _row(rows, label, err, ms, launched, bar, expect=()):
    """A route is OK when its error is under ``bar`` and its first call
    launched exactly the kernels ``expect`` names (none for a plain
    route)."""
    ran = {k for k in launched if not k.endswith("_field_cycles")}
    ok = bool(np.isfinite(err) and err < bar and ran == set(expect))
    rows.append({"route": label, "ok": ok, "err": err, "ms": ms,
                 "launches": launched})
    print(f"{'OK ' if ok else 'BAD'} {label:28s} {ms:9.1f} ms/batch  "
          f"err={err:.2e}  launches {launched}", flush=True)


def _forward_rows(rows, dev):
    grid, s, srcs = medium(3, dev)
    ref = solve_eikonal_batched(s, srcs, grid, EikonalConfig(
        tol=1e-5, max_iters=60, use_pallas="off"))
    s8 = s.expand((N_CHAINED,) + grid.shape)
    cfg = EikonalConfig(tol=1e-3, max_iters=40)
    cfg_j = EikonalConfig(method="jacobi", tol=1e-3, max_iters=400)
    k1 = ("sweep3d_cycle",)
    cases = [("xla (plain sweep)", cfg, "xla", ()),
             ("field (K1)", cfg, "field", k1),
             ("blocked (K1, 2 per iter)", cfg, "blocked", k1),
             ("gridbatch (K1)", cfg, "gridbatch", k1),
             ("jacobi (plain)", cfg_j, None, ())]
    T_field = None
    for label, c, impl, expect in cases:
        def f(ss, c=c, impl=impl):
            s_b, x_b = _flat(ss, srcs)
            return solve_eikonal_batched(s_b, x_b, grid, c, impl=impl)
        T, ms, launched = _chained(f, s8)
        _row(rows, label, float((T[:8] - ref).abs().max()), ms, launched,
             BAR, expect)
        if impl == "field":
            T_field = T
    return grid, s8, srcs, T_field


def _sweep2d_rows(rows, dev):
    grid, s, srcs = medium(2, dev)
    ref = solve_eikonal_batched(s, srcs, grid, EikonalConfig(
        tol=1e-5, max_iters=60, use_pallas="off"))
    s8 = s.expand((N_CHAINED,) + grid.shape)
    cfg = EikonalConfig(tol=1e-3, max_iters=40)
    T_warp = None
    for route in ("warp", "block"):
        def f(ss, route=route):
            s_b, x_b = _flat(ss, srcs)
            T0, _ = seed_source(s_b, x_b, grid, cfg.seed_radius)
            scal = torch.cat(source_scalars(s_b, x_b, grid), dim=1)
            return cuda_sweep.SWEEP2D.solve(
                T0, s_b, scal.contiguous(), grid.spacing, cfg.n_inner,
                cfg.tol, cfg.max_iters, seed_radius=cfg.seed_radius,
                route=route)[0]
        T, ms, launched = _chained(f, s8)
        _row(rows, f"2-D {route} route (K3)",
             float((T[:8] - ref).abs().max()), ms, launched, BAR,
             ("sweep2d",) + (("sweep2d_block_launches",)
                             if route == "block" else ()))
        if route == "warp":
            T_warp = T
    return grid, s8, srcs, T_warp


def _transport_rows(rows, grid, s8, srcs, T, kernels):
    """Each ``(label, cycle or None, kernel count name)`` transport route
    against the plain transport solve on the converged batch ``T``, with
    cotangents drawn from a seed; ``None`` is ``cuda_transport.solve`` (K4
    or K6)."""
    cfg = EikonalConfig(tol=1e-5, max_iters=60)
    s_b, x_b = _flat(s8, srcs)
    ws = batch_weights(T, s_b, x_b, grid, cfg.seed_radius)
    gen = torch.Generator(device=T.device).manual_seed(3)
    g = torch.randn(T.shape, generator=gen, device=T.device).contiguous()
    ref = transport_solve(g, ws, cfg.tol, cfg.max_iters, cfg.n_inner,
                          cycle=transport_cycle_plain)
    scale = float(ref.abs().max())
    for label, cycle, name in kernels:
        def f(ss, cycle=cycle):
            gg = (g * (ss.mean() / s8.mean())).contiguous()
            if cycle is None:
                return cuda_transport.solve(gg, ws, cfg.tol, cfg.max_iters,
                                            cfg.n_inner)
            return transport_solve(gg, ws, cfg.tol, cfg.max_iters,
                                   cfg.n_inner, cycle=cycle)
        lam, ms, launched = _chained(f, s8)
        _row(rows, label, float((lam - ref).abs().max()) / scale, ms,
             launched, TRANSPORT_BAR, (name,))


def run():
    """Every row, printed as it comes; returns the rows."""
    dev = torch.device("cuda")
    rows = []
    grid3, s8, srcs3, T3 = _forward_rows(rows, dev)
    grid2, s8_2, srcs2, T2 = _sweep2d_rows(rows, dev)
    large = functools.partial(cuda_transport.transport_cycle,
                              kernel=cuda_transport.TRANSPORT3D_LARGE)
    _transport_rows(rows, grid3, s8, srcs3, T3,
                    [("transport K4", None, "transport3d_cycle"),
                     ("transport K5 (forced)", large,
                      "transport3d_large_cycle")])
    _transport_rows(rows, grid2, s8_2, srcs2, T2,
                    [("transport 2-D K6", None, "transport2d")])
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("sanity: needs a CUDA device (torch sees none)", file=sys.stderr)
        return 2
    from mceik_tpu_torch.api import prepare_device
    prepare_device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    rows = run()
    bad = [r["route"] for r in rows if not r["ok"]]
    print(f"sanity: {len(rows) - len(bad)} of {len(rows)} routes OK"
          + (f"; BAD {bad}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
