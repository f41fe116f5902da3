"""Ray samplers: spaced, PDF (importance), NeuS iterative upsampling.

Counterpart of ``ponderv2_tpu/models/ponder/render/samplers.py``
(``spaced_bins``, ``UniformSampler``, ``PDFSampler``, ``NeuSSampler``).
Sample counts are static and every tensor is (..., R, S). The JAX samplers
draw their noise from a ``jax.random`` key; here every draw is a tensor
argument (uniforms in [0, 1) of the shape the JAX draw has), so that a test
can hand both packages the same numbers and a trainer can draw them from a
``torch.Generator``. Each sampler's ``draw_shapes`` lists the uniforms one
training render takes, in the order of the JAX sampler's key splits.
``ErrorBoundedSampler`` (VolSDF) and ``UniSurfSampler`` run their
arithmetic in f32 whatever the field's compute dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ....utils.registry import Registry
from .rays import get_weights_from_alphas, sample_positions

SAMPLERS = Registry("samplers")

SPACING_FNS = {
    "uniform": (lambda x: x, lambda x: x),
    "lindisp": (lambda x: 1.0 / x, lambda x: 1.0 / x),
    "sqrt": (torch.sqrt, lambda x: x ** 2),
    "log": (torch.log, torch.exp),
}


def spaced_bins(nears: torch.Tensor, fars: torch.Tensor, num_samples: int,
                spacing: str = "uniform",
                jitter: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, ends) of shape (..., R, num_samples) between near and far.
    ``jitter`` (..., R, num_samples + 1) uniforms stratify the bins (the JAX
    ``train_stratified`` draw); None keeps them evenly spaced."""
    shape = nears.shape
    u = torch.linspace(0.0, 1.0, num_samples + 1, device=nears.device)
    u = u.expand(*shape, num_samples + 1)
    if jitter is not None:
        j = jitter - 0.5
        u_mid = (u[..., 1:] + u[..., :-1]) / 2
        u_centered = torch.cat([u[..., :1], u_mid, u[..., -1:]], -1)
        lower, upper = u_centered[..., :-1], u_centered[..., 1:]
        u = lower + (upper - lower) * (j + 0.5)
    n, f = nears[..., None], fars[..., None]
    if spacing == "uniform_lindisp_piecewise":
        mid = (n + f) / 2
        lin = n + (mid - n) * (u * 2.0)
        disp = 1.0 / (1.0 / torch.clamp(mid, min=1e-6) * (2.0 - 2.0 * u)
                      + 1.0 / torch.clamp(f, min=1e-6) * (2.0 * u - 1.0))
        bins = torch.where(u < 0.5, lin, disp)
    else:
        fn, fn_inv = SPACING_FNS[spacing]
        s_n, s_f = fn(torch.clamp(n, min=1e-6)), fn(torch.clamp(f, min=1e-6))
        bins = fn_inv(s_n + (s_f - s_n) * u)
    return bins[..., :-1], bins[..., 1:]


@SAMPLERS.register_module()
class UniformSampler:
    def __init__(self, num_samples: int, train_stratified: bool = True,
                 spacing: str = "uniform"):
        self.num_samples = num_samples
        self.train_stratified = train_stratified
        self.spacing = spacing

    def draw_shape(self, rays_shape) -> Tuple[int, ...]:
        return (*rays_shape, self.num_samples + 1)

    def __call__(self, nears, fars, train: bool = False, u=None):
        jitter = u if (self.train_stratified and train) else None
        return spaced_bins(nears, fars, self.num_samples, self.spacing, jitter)


@SAMPLERS.register_module()
class PDFSampler:
    """Inverse-CDF importance sampling from existing bin weights."""

    def __init__(self, num_samples: int, train_stratified: bool = True,
                 include_original: bool = False, histogram_padding: float = 0.01):
        self.num_samples = num_samples
        self.train_stratified = train_stratified
        self.include_original = include_original
        self.histogram_padding = histogram_padding

    def draw_shape(self, rays_shape) -> Tuple[int, ...]:
        return (*rays_shape, self.num_samples + 1)

    def __call__(self, starts, ends, weights, train: bool = False, u=None):
        """starts/ends/weights (..., R, S) -> (..., R, num_samples) bins; ``u``
        (..., R, num_samples + 1) uniforms jitter the CDF positions."""
        num_bins = self.num_samples + 1
        w = weights + self.histogram_padding
        pdf = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-10)
        cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
        cdf = torch.clamp(cdf, 0.0, 1.0)
        if self.train_stratified and train and u is not None:
            pos = (torch.arange(num_bins, device=cdf.device) + u) / num_bins
            pos = torch.clamp(pos, 0.0, 1.0 - 1e-6)
        else:
            pos = torch.linspace(0.0, 1.0 - 1e-6, num_bins, device=cdf.device)
            pos = pos.expand(*cdf.shape[:-1], num_bins)
        edges = torch.cat([starts, ends[..., -1:]], -1)  # (..., S+1)
        # right-searchsorted as a comparison count, so ties resolve as in JAX
        idx = (pos[..., None, :] >= cdf[..., :, None]).sum(-2)
        last = cdf.shape[-1] - 1
        below = torch.clamp(idx - 1, 0, last)
        above = torch.clamp(idx, 0, last)
        cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
        edge_b, edge_a = edges.gather(-1, below), edges.gather(-1, above)
        denom = torch.where(cdf_a - cdf_b < 1e-8, torch.ones_like(cdf_a), cdf_a - cdf_b)
        t = (pos - cdf_b) / denom
        samples = (edge_b + t * (edge_a - edge_b)).detach()
        return samples[..., :-1], samples[..., 1:]


def _merged_bins(starts_a, starts_b, last_end):
    """The union of two sets of sample starts as contiguous bins: sorted
    starts, each end the next start, the last end the larger of
    ``last_end`` (..., R) and the last start."""
    starts = torch.sort(torch.cat([starts_a, starts_b], -1), dim=-1, stable=True).values
    ends_last = torch.maximum(last_end[..., None], starts[..., -1:])
    return starts, torch.cat([starts[..., 1:], ends_last], -1)


@SAMPLERS.register_module()
class NeuSSampler:
    """NeuS hierarchical sampling: uniform base + importance upsampling rounds
    with a fixed inv_s schedule."""

    def __init__(self, num_samples: int = 64, num_samples_importance: int = 64,
                 num_upsample_steps: int = 4, base_variance: float = 64.0,
                 train_stratified: bool = True):
        self.num_samples = num_samples
        self.num_samples_importance = num_samples_importance
        self.num_upsample_steps = num_upsample_steps
        self.base_variance = base_variance
        self.uniform = UniformSampler(num_samples, train_stratified)
        self.pdf = PDFSampler(num_samples_importance // num_upsample_steps,
                              train_stratified=train_stratified,
                              include_original=False)

    def total_samples(self) -> int:
        return self.num_samples + self.num_samples_importance

    def draw_shapes(self, rays_shape) -> Tuple[Tuple[int, ...], ...]:
        """Shapes of the uniforms one training render draws: the stratified
        jitter, then one PDF draw per upsample step (the JAX sampler's
        ``split(rng, steps + 1)`` keys, in order)."""
        return ((self.uniform.draw_shape(rays_shape),)
                + (self.pdf.draw_shape(rays_shape),) * self.num_upsample_steps)

    def __call__(self, nears, fars, sdf_fn: Callable, origins, directions,
                 train: bool = False, draws: Optional[Sequence[torch.Tensor]] = None):
        """sdf_fn(positions (..., R, S, 3)) -> sdf (..., R, S). Returns (starts,
        ends) with ``total_samples()`` sorted samples per ray."""
        draws = list(draws) if draws is not None else [None] * (self.num_upsample_steps + 1)
        starts, ends = self.uniform(nears, fars, train=train, u=draws[0])
        for step in range(self.num_upsample_steps):
            with torch.no_grad():
                sdf = sdf_fn(sample_positions(origins, directions, starts, ends))
            inv_s = self.base_variance * 2 ** step
            alphas = self._sdf_to_alpha(sdf, starts, ends, inv_s)
            weights, _ = get_weights_from_alphas(alphas)
            new_starts, _ = self.pdf(starts, ends, weights, train=train,
                                     u=draws[step + 1])
            starts, ends = _merged_bins(starts, new_starts, ends[..., -1])
        return starts, ends

    @staticmethod
    def _sdf_to_alpha(sdf, starts, ends, inv_s):
        """NeuS alpha from section-estimated sdf."""
        prev_sdf = sdf
        next_sdf = torch.cat([sdf[..., 1:], sdf[..., -1:]], -1)
        mid_sdf = 0.5 * (prev_sdf + next_sdf)
        delta = torch.clamp(ends - starts, min=1e-6)
        cos_val = torch.clamp((next_sdf - prev_sdf) / delta, -1e3, 0.0)
        est_prev = mid_sdf - cos_val * delta * 0.5
        est_next = mid_sdf + cos_val * delta * 0.5
        cdf_prev = torch.sigmoid(est_prev * inv_s)
        cdf_next = torch.sigmoid(est_next * inv_s)
        alpha = (cdf_prev - cdf_next + 1e-5) / torch.clamp(cdf_prev, min=1e-5)
        return torch.clamp(alpha, 0.0, 1.0)


@SAMPLERS.register_module()
class NeuSAccSampler(NeuSSampler):
    """Alias (the reference has an acceleration variant; the same function)."""


def laplace_density(sdf: torch.Tensor, beta) -> torch.Tensor:
    """VolSDF Laplace-CDF density: sigma(s) = (1/beta) Psi_beta(-s)."""
    return (0.5 + 0.5 * torch.sign(-sdf) * (1.0 - torch.exp(-sdf.abs() / beta))) / beta


def volsdf_dstar(sdf: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """VolSDF Theorem 1 bound d* per section: the least |sdf| possible in a
    section of length a with endpoint distances b, c (triangle altitude),
    zero where the endpoint signs differ."""
    a = deltas[..., :-1]
    b = sdf[..., :-1].abs()
    c = sdf[..., 1:].abs()
    first = a ** 2 + b ** 2 <= c ** 2
    second = a ** 2 + c ** 2 <= b ** 2
    s = (a + b + c) / 2.0
    area2 = torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)
    altitude = 2.0 * torch.sqrt(area2) / torch.clamp(a, min=1e-10)
    d_star = torch.where(first, b, torch.where(second, c, torch.where(
        (b + c - a) > 0, altitude, torch.zeros_like(altitude))))
    same_sign = torch.sign(sdf[..., 1:]) * torch.sign(sdf[..., :-1]) == 1
    d_star = torch.where(same_sign, d_star, torch.zeros_like(d_star))
    return torch.cat([d_star, d_star[..., -1:]], -1)


def _error_integral(d_star, deltas, beta):
    """Cumulative Theorem-1 error per section at ``beta`` (..., R, 1)."""
    return torch.cumsum(torch.exp(-d_star / beta) * deltas ** 2 / (4.0 * beta ** 2), -1)


def volsdf_error_bound(beta, sdf, d_star, deltas) -> torch.Tensor:
    """Max per-ray opacity-error bound at ``beta`` (a number or (..., R, 1))."""
    delta_density = deltas * laplace_density(sdf, beta)
    integral = torch.cumsum(delta_density[..., :-1], -1)
    integral = torch.cat([torch.zeros_like(integral[..., :1]), integral], -1)
    # exp overflows to inf before the clip, as in the JAX function
    bound = (torch.clamp(torch.exp(_error_integral(d_star, deltas, beta)), max=1.0e6)
             - 1.0) * torch.exp(-integral)
    return bound.amax(-1)


@SAMPLERS.register_module()
class ErrorBoundedSampler:
    """VolSDF error-bounded sampling, Algorithm 1: uniform eval samples;
    per-ray beta from the Lemma-2 bound, refined by ``beta_iters``
    bisection steps between beta0 and it against the Theorem-1 error
    bound; ``max_total_iters - 1`` rounds add eval samples in proportion to
    the error bound, and the last PDF-samples ``num_samples`` from the
    Laplace-density weights; ``num_samples_extra`` evenly spaced samples are
    merged at the end. As in the JAX sampler, every round runs, with
    per-ray beta (the reference stops once every beta reaches beta0)."""

    def __init__(self, num_samples: int = 64, num_samples_eval: int = 128,
                 num_samples_extra: int = 32, eps: float = 0.1,
                 beta_iters: int = 10, max_total_iters: int = 5,
                 train_stratified: bool = True):
        self.num_samples = num_samples
        self.num_samples_eval = num_samples_eval
        self.num_samples_extra = num_samples_extra
        self.eps = eps
        self.beta_iters = beta_iters
        self.max_total_iters = max_total_iters
        self.uniform = UniformSampler(num_samples_eval, train_stratified)
        self.pdf = PDFSampler(num_samples, train_stratified=train_stratified)
        self.pdf_eval = PDFSampler(num_samples_eval, train_stratified=train_stratified)

    def total_samples(self) -> int:
        return self.num_samples + self.num_samples_extra

    def draw_shapes(self, rays_shape) -> Tuple[Tuple[int, ...], ...]:
        """The stratified jitter, then one PDF draw a round (the eval rounds'
        then the last's sizes): the JAX sampler's ``split(rng, rounds + 2)``
        keys in order, the last of which it never uses."""
        return ((self.uniform.draw_shape(rays_shape),)
                + (self.pdf_eval.draw_shape(rays_shape),) * (self.max_total_iters - 1)
                + (self.pdf.draw_shape(rays_shape),))

    def _update_beta(self, beta0, beta, sdf, d_star, deltas):
        """Bisection in [beta0, beta] for the least beta whose error bound
        is at most ``eps``."""
        err_at_b0 = volsdf_error_bound(beta0, sdf, d_star, deltas)
        beta = torch.where(err_at_b0 <= self.eps, torch.full_like(beta, beta0), beta)
        beta_min = torch.full_like(beta, beta0)
        beta_max = beta
        for _ in range(self.beta_iters):
            beta_mid = 0.5 * (beta_min + beta_max)
            err = volsdf_error_bound(beta_mid[..., None], sdf, d_star, deltas)
            beta_max = torch.where(err <= self.eps, beta_mid, beta_max)
            beta_min = torch.where(err > self.eps, beta_mid, beta_min)
        return beta_max

    @torch.no_grad()
    def __call__(self, nears, fars, sdf_fn: Callable, origins, directions,
                 train: bool = False, draws: Optional[Sequence[torch.Tensor]] = None,
                 beta0: float = 0.1):
        """Returns (starts, ends) with ``total_samples()`` sorted samples per
        ray; no grads flow through them."""
        draws = list(draws) if draws is not None else [None] * (self.max_total_iters + 1)
        nears, fars = nears.float(), fars.float()
        starts, ends = self.uniform(nears, fars, train=train, u=draws[0])
        deltas = torch.clamp(ends - starts, min=1e-6)
        beta = torch.sqrt((1.0 / (4.0 * math.log(self.eps + 1.0))) * (deltas ** 2).sum(-1))
        fine_starts = None
        for it in range(self.max_total_iters):
            sdf = sdf_fn(sample_positions(origins, directions, starts, ends)).float()
            deltas = torch.clamp(ends - starts, min=1e-6)
            d_star = volsdf_dstar(sdf, deltas)
            beta = self._update_beta(beta0, beta, sdf, d_star, deltas)
            density = laplace_density(sdf, beta[..., None])
            weights, transmittance = get_weights_from_alphas(
                1.0 - torch.exp(-density * deltas))
            if it < self.max_total_iters - 1:
                # error-bound-proportional eval samples (Alg. 1 line 10)
                err_weights = (torch.clamp(torch.exp(_error_integral(
                    d_star, deltas, beta[..., None])), max=1.0e6) - 1.0) * transmittance
                new_starts, _ = self.pdf_eval(starts, ends, err_weights, train=train,
                                              u=draws[it + 1])
                starts, ends = _merged_bins(starts, new_starts, ends[..., -1])
            else:
                # the last round: the rendering samples from density weights
                fine_starts, _ = self.pdf(starts, ends, weights, train=train,
                                          u=draws[it + 1])
        extra = torch.linspace(0.0, 1.0, self.num_samples_extra, device=nears.device)
        extra = nears[..., None] + (fars - nears)[..., None] * extra
        return _merged_bins(fine_starts, extra, fars)


@SAMPLERS.register_module()
class UniSurfSampler:
    """UniSurf surface-interval sampling: ``num_marching_steps`` coarse
    samples; ``num_samples_importance`` importance samples from occupancy
    weights; the first outside -> inside sign change of the sdf (the
    cost-matrix argmin, first minimum), its depth z by linear
    interpolation, and ``num_samples_interval`` samples in [z - dist *
    delta, z + dist * delta] clipped to near / far (rays without a crossing
    keep the whole range). Returns the sorted merge of both."""

    def __init__(self, num_samples_importance: int = 32, num_samples_interval: int = 32,
                 num_marching_steps: int = 128, delta: float = 0.05,
                 train_stratified: bool = True):
        self.num_samples_importance = num_samples_importance
        self.num_samples_interval = num_samples_interval
        self.num_marching_steps = num_marching_steps
        self.delta = delta
        self.march = UniformSampler(num_marching_steps, train_stratified=False)
        self.pdf = PDFSampler(num_samples_importance, train_stratified=train_stratified)

    def total_samples(self) -> int:
        return self.num_samples_importance + self.num_samples_interval

    def draw_shapes(self, rays_shape) -> Tuple[Tuple[int, ...], ...]:
        """The importance PDF draw, then the interval's stratified jitter
        (the JAX sampler's ``split(rng, 2)`` keys in order)."""
        return (self.pdf.draw_shape(rays_shape),
                (*rays_shape, self.num_samples_interval + 1))

    def find_surface(self, m_starts, sdf, nears, fars):
        """The first outside -> inside crossing depth per ray: (z, mask)."""
        n_samples = sdf.shape[-1]
        sign_matrix = torch.cat([torch.sign(sdf[..., :-1] * sdf[..., 1:]),
                                 torch.ones_like(sdf[..., :1])], -1)
        cost = sign_matrix * torch.arange(n_samples, 0, -1, dtype=sdf.dtype,
                                          device=sdf.device)
        values, indices = cost.min(-1, keepdim=True)  # the first minimum
        sdf_at = sdf.gather(-1, indices)[..., 0]
        mask = (values[..., 0] < 0) & (sdf_at > 0)
        d_low = m_starts.gather(-1, indices)[..., 0]
        idx_hi = torch.clamp(indices + 1, max=n_samples - 1)
        d_high = m_starts.gather(-1, idx_hi)[..., 0]
        v_high = sdf.gather(-1, idx_hi)[..., 0]
        diff = sdf_at - v_high
        denom = torch.where(diff.abs() < 1e-12, torch.ones_like(diff), diff)
        return (sdf_at * d_high - v_high * d_low) / denom, mask

    @torch.no_grad()
    def __call__(self, nears, fars, sdf_fn: Callable, origins, directions,
                 train: bool = False, draws: Optional[Sequence[torch.Tensor]] = None,
                 occupancy_fn: Optional[Callable] = None):
        draws = list(draws) if draws is not None else [None, None]
        nears, fars = nears.float(), fars.float()
        m_starts, m_ends = self.march(nears, fars)
        sdf = sdf_fn(sample_positions(origins, directions, m_starts, m_ends)).float()
        if occupancy_fn is None:
            occupancy_fn = lambda s: torch.sigmoid(-10.0 * s)  # noqa: E731
        weights, _ = get_weights_from_alphas(occupancy_fn(sdf))
        imp_starts, _ = self.pdf(m_starts, m_ends, weights, train=train, u=draws[0])
        z, mask = self.find_surface(m_starts, sdf, nears, fars)
        dists = fars - nears
        lo = torch.where(mask, torch.maximum(z - dists * self.delta, nears), nears)
        hi = torch.where(mask, torch.minimum(z + dists * self.delta, fars), fars)
        interval = UniformSampler(self.num_samples_interval, train_stratified=train)
        i_starts, _ = interval(lo, hi, train=train, u=draws[1])
        return _merged_bins(imp_starts, i_starts, fars)
