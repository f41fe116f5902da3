"""Ray samplers: spaced, PDF (importance), NeuS iterative upsampling.

Counterpart of ``ponderv2_tpu/models/ponder/render/samplers.py``
(``spaced_bins``, ``UniformSampler``, ``PDFSampler``, ``NeuSSampler``).
Sample counts are static and every tensor is (..., R, S). The JAX samplers
draw their noise from a ``jax.random`` key; here every draw is a tensor
argument (uniforms in [0, 1) of the shape the JAX draw has), so that a test
can hand both packages the same numbers and a trainer can draw them from a
``torch.Generator``. ``ErrorBoundedSampler``, ``UniSurfSampler`` and the
VolSDF helpers are not ported yet.
"""

from __future__ import annotations

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
            all_starts = torch.sort(torch.cat([starts, new_starts], -1), -1).values
            ends_last = torch.maximum(ends[..., -1:], all_starts[..., -1:])
            starts = all_starts
            ends = torch.cat([all_starts[..., 1:], ends_last], -1)
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
