"""The plain tomography posterior: the benchmark's data and its reference.

Plain PyTorch, imports nothing of the program. From a configuration file of
``portbench/configs/`` (the ``grid``, ``eikonal``, ``model`` and ``data``
groups) it makes the benchmark's inputs, which both sides are handed, and
works out again what the program derives from them:

- the data (:func:`make_data`): the smooth checkerboard truth
  ``s = s_bg * exp(A * prod_d sin(pi k_d x_d / L_d))``, the acquisition
  (config 2's borehole faces in 3-D, config 4's crosswell in 2-D), the
  traveltimes through the truth by the plain solve, and the noise, drawn
  from the run's seed;
- the posterior (:class:`Posterior`): ``u`` on the coarse inversion grid,
  upsampled linearly (half-pixel centres, clamped edges) as three (or two)
  matrix products, ``s = s_bg * exp(up(u))``, one traveltime field per
  source (the smaller side of the acquisition, by reciprocity), interpolated
  at the receivers; the Gaussian likelihood with fixed noise and the
  Gaussian prior on ``u``; the gradient through the implicit adjoint.

The upsample is matrix products, so TF32 (``torch.backends.cuda.matmul``)
changes it: that is the control's lower precision.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from reference import eikonal


def _axes(shape, spacing, origin):
    return [o + h * np.arange(n) for n, h, o in zip(shape, spacing, origin)]


def checkerboard(grid: Dict, cells, amplitude: float, background: float,
                 device) -> torch.Tensor:
    """The truth slowness on the forward grid."""
    shape, spacing = grid["shape"], grid["spacing"]
    origin = grid.get("origin", [0.0] * len(shape))
    pattern = torch.ones(tuple(shape), dtype=torch.float32, device=device)
    for d, x in enumerate(_axes(shape, spacing, origin)):
        extent = (shape[d] - 1) * spacing[d]
        frac = torch.as_tensor((x - origin[d]) / max(extent, 1e-12),
                               dtype=torch.float32, device=device)
        view = [1] * len(shape)
        view[d] = shape[d]
        pattern = pattern * torch.sin(math.pi * cells[d] * frac).reshape(view)
    return background * torch.exp(amplitude * pattern)


def acquisition(grid: Dict, data: Dict,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sources and receivers in physical coordinates: the crosswell (2-D:
    sources down the well at 8% of the width, receivers at 92%, from 8% to
    92% of the depth) or the borehole faces (3-D: a k x k lattice from 10%
    to 90% of y and z, k = ceil(sqrt(n)), sources at 5% of x, receivers at
    95%)."""
    shape, spacing = grid["shape"], grid["spacing"]
    lo = np.asarray(grid.get("origin", [0.0] * len(shape)), dtype=np.float64)
    ext = np.asarray([(n - 1) * h for n, h in zip(shape, spacing)])
    n_src, n_rec = data["n_src"], data["n_rec"]
    if data["dataset"] == "crosswell2d":
        m = 0.08
        src = np.stack([np.full(n_src, lo[0] + m * ext[0]),
                        lo[1] + ext[1] * np.linspace(m, 1 - m, n_src)], -1)
        rec = np.stack([np.full(n_rec, lo[0] + (1 - m) * ext[0]),
                        lo[1] + ext[1] * np.linspace(m, 1 - m, n_rec)], -1)
    elif data["dataset"] == "checkerboard3d":
        def face(n, xfrac):
            k = int(np.ceil(np.sqrt(n)))
            ys = lo[1] + ext[1] * np.linspace(0.1, 0.9, k)
            zs = lo[2] + ext[2] * np.linspace(0.1, 0.9, k)
            Y, Z = np.meshgrid(ys, zs, indexing="ij")
            return np.stack([np.full(k * k, lo[0] + xfrac * ext[0]),
                             Y.ravel(), Z.ravel()], -1)[:n]
        src, rec = face(n_src, 0.05), face(n_rec, 0.95)
    else:
        raise ValueError(f"no plain acquisition for dataset "
                         f"{data['dataset']!r}")
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return as_t(src), as_t(rec)


def resample_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """``(n_out, n_in)`` weights of linear resampling with half-pixel centres
    and clamped edges: output ``i`` reads input position
    ``max((i + 0.5) n_in / n_out - 0.5, 0)``."""
    pos = np.maximum((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0.0)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = pos - i0
    A = np.zeros((n_out, n_in))
    np.add.at(A, (np.arange(n_out), i0), 1.0 - f)
    np.add.at(A, (np.arange(n_out), i1), f)
    return torch.as_tensor(A, dtype=torch.float32, device=device)


class Posterior:
    """The plain posterior of one configuration over given data.

    ``cfg`` is a configuration file's content; ``data`` holds ``src``,
    ``rec`` (physical coordinates) and ``t_obs`` ``(n_src, n_rec)``. Every
    method takes ``u`` with a leading chain axis and works one block of
    chains at a time (``block`` chains), so that it fits beside whatever
    the card holds."""

    def __init__(self, cfg: Dict, data: Dict, device, block: int):
        g, e, m = cfg["grid"], cfg["eikonal"], cfg["model"]
        self.shape = tuple(g["shape"])
        self.spacing = tuple(float(h) for h in g["spacing"])
        self.origin = tuple(float(o) for o in g.get("origin",
                                                    [0.0] * len(self.shape)))
        self.tol, self.max_iters = float(e["tol"]), int(e["max_iters"])
        self.n_inner = int(e.get("n_inner", 2))
        self.seed_radius = float(e.get("seed_radius", 3.0))
        self.inv_shape = tuple(m["inv_shape"])
        self.bg = float(m["background_slowness"])
        self.prior_sigma = float(m["prior_sigma_u"])
        self.sigma = float(m["sigma"])
        self.block = block
        self.device = device
        self.mats = [resample_matrix(a, b, device)
                     for a, b in zip(self.inv_shape, self.shape)]
        src, rec, self.t_obs = data["src"], data["rec"], data["t_obs"]
        # Tables from the smaller side (reciprocity).
        self.from_src = src.shape[0] <= rec.shape[0]
        self.tab, self.pts = (src, rec) if self.from_src else (rec, src)

    def index(self, xyz: torch.Tensor) -> torch.Tensor:
        o = torch.tensor(self.origin, dtype=xyz.dtype, device=xyz.device)
        h = torch.tensor(self.spacing, dtype=xyz.dtype, device=xyz.device)
        return (xyz - o) / h

    def slowness(self, u: torch.Tensor) -> torch.Tensor:
        """``(C,) + inv_shape -> (C,) + grid``."""
        x = u
        for d, A in enumerate(self.mats):
            x = torch.tensordot(x, A, dims=([d + 1], [1])).movedim(-1, d + 1)
        return self.bg * torch.exp(x)

    def _fields(self, s: torch.Tensor):
        """The batch of ``C * n_tab`` fields and their sources' index
        coordinates."""
        C, n_tab = s.shape[0], self.tab.shape[0]
        s_b = s.unsqueeze(1).expand((C, n_tab) + self.shape).reshape(
            (C * n_tab,) + self.shape).contiguous()
        src = self.index(self.tab).repeat(C, 1)
        return s_b, src

    def _lik(self, T: torch.Tensor, C: int) -> torch.Tensor:
        n_tab, n_pts = self.tab.shape[0], self.pts.shape[0]
        idx = self.index(self.pts).unsqueeze(0).expand(C * n_tab, n_pts, -1)
        t = eikonal.interp(T, idx).reshape(C, n_tab, n_pts)
        if not self.from_src:
            t = t.transpose(1, 2)
        r = (self.t_obs - t) / self.sigma
        return (-0.5 * (r * r).flatten(1).sum(1)
                - math.log(self.sigma) * r[0].numel())

    def _prior(self, u: torch.Tensor) -> torch.Tensor:
        return -0.5 * ((u / self.prior_sigma) ** 2).flatten(1).sum(1)

    def _solve(self, s_b, src):
        return eikonal.solve(s_b, src, self.spacing, self.tol, self.max_iters,
                             self.n_inner, self.seed_radius)

    def terms(self, u: torch.Tensor):
        """``(log prior, log likelihood)``, each ``(C,)``."""
        prior, lik = [], []
        for c in range(0, u.shape[0], self.block):
            ub = u[c:c + self.block]
            with torch.no_grad():
                T, _ = self._solve(*self._fields(self.slowness(ub)))
                prior.append(self._prior(ub))
                lik.append(self._lik(T, ub.shape[0]))
        return torch.cat(prior), torch.cat(lik)

    def logpost(self, u: torch.Tensor) -> torch.Tensor:
        """``(C,)`` log posterior: the log prior and the log likelihood with
        its ``-n_obs log(sigma)``, as the program counts it."""
        prior, lik = self.terms(u)
        return prior + lik

    def gradient_terms(self, u: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The log prior and log likelihood ``(C,)`` and their gradients in
        ``u``, the likelihood's through the implicit adjoint: ``prior``,
        ``lik``, ``g_prior``, ``g_lik``."""
        out = {"prior": [], "lik": [], "g_prior": [], "g_lik": []}
        for c in range(0, u.shape[0], self.block):
            ub = u[c:c + self.block].detach().requires_grad_(True)
            C = ub.shape[0]
            with torch.enable_grad():
                s = self.slowness(ub)
            s_b, src = self._fields(s.detach())
            with torch.no_grad():
                T, _ = self._solve(s_b, src)
            Tl = T.clone().requires_grad_(True)
            with torch.enable_grad():
                lik = self._lik(Tl, C)
                (g,) = torch.autograd.grad(lik.sum(), [Tl])
            grad_s = torch.empty_like(s_b)
            step = max(1, (1 << 24) // T[0].numel())
            for f in range(0, s_b.shape[0], step):
                sl = slice(f, f + step)
                _, frozen = eikonal.seed(s_b[sl], src[sl], self.spacing,
                                         self.seed_radius)
                ws = eikonal.transport_weights(T[sl], s_b[sl], frozen,
                                               self.spacing)
                lam = eikonal.transport_solve(g[sl], ws, self.tol,
                                              self.max_iters, self.n_inner)
                s_leaf = s_b[sl].detach().requires_grad_(True)
                with torch.enable_grad():
                    F = eikonal.fixed_point_map(T[sl], s_leaf, src[sl],
                                                self.spacing, self.seed_radius)
                    (grad_s[sl],) = torch.autograd.grad(F, [s_leaf], lam)
            n_tab = self.tab.shape[0]
            grad_s = grad_s.reshape((C, n_tab) + self.shape).sum(1)
            with torch.enable_grad():
                (g_lik,) = torch.autograd.grad(s, [ub], grad_s)
                prior = self._prior(ub)
                (g_prior,) = torch.autograd.grad(prior.sum(), [ub])
            for k, v in (("prior", prior), ("lik", lik), ("g_prior", g_prior),
                         ("g_lik", g_lik)):
                out[k].append(v.detach())
        return {k: torch.cat(v) for k, v in out.items()}


def make_data(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's inputs for one run: the acquisition, and the
    traveltimes through the truth plus ``noise`` times standard normals
    drawn from ``seed`` (a generator on ``device``)."""
    g, m, d = cfg["grid"], cfg["model"], cfg["data"]
    src, rec = acquisition(g, d, device)
    truth = checkerboard(g, d["checker_cells"], d["checker_amplitude"],
                         m["background_slowness"], device)
    post = Posterior(cfg, {"src": src, "rec": rec, "t_obs": None}, device, 1)
    s_b, src_idx = post._fields(truth.unsqueeze(0))
    with torch.no_grad():
        T, _ = post._solve(s_b, src_idx)
    n_tab = post.tab.shape[0]
    idx = post.index(post.pts).unsqueeze(0).expand(n_tab, -1, -1)
    t = eikonal.interp(T, idx)
    t_clean = t if post.from_src else t.T
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    noise = torch.randn(t_clean.shape, generator=gen, dtype=torch.float32,
                        device=device)
    return {"src": src, "rec": rec,
            "t_obs": (t_clean + d["noise"] * noise).contiguous()}


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for fp32 matrix products on (or off) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.set_float32_matmul_precision("high" if enabled else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def for_config(cfg: Dict, data: Dict, device):
    """The posterior with a chain block of at most 2^27 nodes of fields (a
    few GB of temporaries: c2's 16 chains and c4's 10,000 particles in one
    and two blocks)."""
    n_tab = min(data["src"].shape[0], data["rec"].shape[0])
    per_chain = n_tab * math.prod(cfg["grid"]["shape"])
    return Posterior(cfg, data, device, max(1, (1 << 27) // per_chain))
