"""Evolutionary and Monte-Carlo search: gradient-free optimisation over a
batch of candidates (mirrors ``fpyv_tpu.rl.es``).

Where the JAX package vmaps a per-candidate ``f`` or fitness over the
population inside one ``lax.scan``, the port hands the whole population to
``f`` at once (the caller writes it batched: the ES trainer's fitness runs
every candidate's env bank in one batched forward and one env step) and
loops over generations on the host. Every draw goes through a module-level
function (:func:`offspring_noise`, :func:`es_noise`) that the tests replace
with JAX's draws.

With a ``mesh`` (:func:`fpyv_tpu_torch.parallel.mesh.make_mesh`) the
population is split over the ranks: every rank draws theta's perturbations
from the same generator, evaluates its slice of the 2P candidates, and one
all-reduce of the zero-padded (2P,) fitness gathers them; the ranks, the
gradient and the sigma step then run alike on every rank. As in JAX, the
result does not depend on the layout.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from fpyv_tpu_torch.device import divisor, resolve_device
from fpyv_tpu_torch.interop import ravel_params, unravel_params


def offspring_noise(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """The offspring's standard normal noise."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def es_noise(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """A generation's (P, dim) antithetic perturbations, standard normal."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def _offspring(generator, best_x: torch.Tensor, n_offspring: int, noise_std: float):
    """The incumbent tiled, plus unit-normalised noise times noise_std."""
    noise = offspring_noise((n_offspring,) + tuple(best_x.shape), generator, best_x.dtype,
                            best_x.device)
    norm = torch.linalg.vector_norm(noise.reshape(n_offspring, -1), dim=1)
    noise = noise / torch.clamp_min(norm, 1e-12).reshape((n_offspring,) + (1,) * best_x.ndim)
    return best_x[None] + noise_std * noise


def monte_carlo_search(
    generator: torch.Generator,
    x0: torch.Tensor,
    f: Callable[[torch.Tensor], torch.Tensor],  # (B, ...) candidates -> (B,) scores
    n_offspring: int = 64,
    n_iterations: int = 100,
    noise_std: float = 0.1,
    temperature: float = 1.0,
    maximize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-weighted evolutionary search; returns (best_x, best_score).

    ``f`` scores a batch of candidates shaped like ``x0`` with a leading
    batch axis; it is called on all offspring of a generation at once, and
    on single points as a batch of one. Each generation recombines the
    offspring with a softmax over their scores, keeps the elite where the
    recombined point scores lower, and moves the incumbent only on a strict
    improvement."""
    sign = 1.0 if maximize else -1.0

    def score(x):
        return sign * f(x[None])[0]

    x_best, s_best = x0, score(x0)
    for _ in range(n_iterations):
        cand = _offspring(generator, x_best, n_offspring, noise_std)
        scores = sign * f(cand)
        w = torch.softmax(scores / max(temperature, 1e-9), dim=0)
        x_mix = torch.tensordot(w, cand, dims=1)
        s_mix = score(x_mix)
        i_best = torch.argmax(scores)
        keep_mix = s_mix >= scores[i_best]
        x_new = torch.where(keep_mix, x_mix, cand[i_best])
        s_new = torch.where(keep_mix, s_mix, scores[i_best])
        improved = s_new > s_best
        x_best = torch.where(improved, x_new, x_best)
        s_best = torch.where(improved, s_new, s_best)
    return x_best, sign * s_best


def centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """Fitness -> ranks in [-0.5, 0.5] (the OpenAI-ES utility transform);
    ties rank in index order, as JAX's stable argsort ranks them."""
    ranks = torch.argsort(torch.argsort(x, stable=True), stable=True).to(torch.float32)
    return ranks / divisor(x.shape[0] - 1, ranks) - 0.5


def make_policy_es(
    params: dict,
    fitness_fn: Callable,  # fitness_fn(params_batch, generator, common_randomness) -> (B,)
    *,
    n_perturbations: int = 32,
    noise_std: float = 0.05,
    learning_rate: float = 0.02,
    common_randomness: bool = True,
    mesh=None,
    sigma_decay: float = 1.0,
    sigma_min: float = 1e-3,
    device=None,  # CUDA unless "cpu"
):
    """NES over a parameter tree (a nested dict of arrays or tensors).

    Returns ``(init_state, run_chunk, unravel)``:

    - ``init_state() -> (theta, sigma, best)``: theta is
      :func:`~fpyv_tpu_torch.interop.ravel_params` of ``params`` (JAX's
      ``ravel_pytree`` order), sigma ``noise_std``, best -inf, 0-d tensors;
    - ``run_chunk(es_state, n, generator) -> (es_state, gen_best (n,))``:
      ``n`` generations, each drawing (P, dim) perturbations through
      :func:`es_noise`, evaluating the 2P antithetic candidates in one call
      ``fitness_fn(unravel(cand), generator, common_randomness)`` (the tree's
      leaves gain a leading (2P,) axis; with ``common_randomness`` the
      fitness draws its episodes once and shares them across the
      candidates), and stepping theta along the centered-rank estimate of
      the gradient. ``sigma_decay`` shrinks sigma (floored at
      ``sigma_min``) after a generation that does not beat the best so far;
    - ``unravel(theta) -> tree``.

    Theta and the generation's arithmetic live on ``device``, CUDA unless
    ``device="cpu"``, wherever the tree's leaves were (the mesh's device
    with a ``mesh``).

    With a ``mesh`` each rank hands ``fitness_fn`` its contiguous slice
    ``mesh.part(2P)`` of the candidates (the leaves' leading axis), and the
    fitness of all 2P is gathered by one all-reduce (a sum of zero-padded
    vectors). A fitness whose draws are shaped by the candidates draws them
    at the whole population's shape and slices them, so that every rank
    consumes the generator alike.
    """
    theta0 = ravel_params(params, mesh.device if mesh is not None else resolve_device(device))
    P = n_perturbations
    if mesh is not None:
        # imported here: parallel imports rl.ppo, whose package imports this
        from fpyv_tpu_torch.parallel.mesh import psum_, replicate

        replicate([theta0], mesh)
        lo, hi, _ = mesh.part(2 * P)

    def evaluate(cand, generator):
        if mesh is None:
            return fitness_fn(unravel(cand), generator, common_randomness)
        local = fitness_fn(unravel(cand[lo:hi]), generator, common_randomness)
        fits = torch.zeros(2 * P, dtype=local.dtype, device=local.device)
        fits[lo:hi] = local
        return psum_(fits, mesh)

    def unravel(theta: torch.Tensor) -> dict:
        return unravel_params(theta, params)

    def generation(es_state, generator):
        theta, sigma, best = es_state
        eps = es_noise((P, theta.shape[0]), generator, theta.dtype, theta.device)
        cand = torch.cat([theta[None] + sigma * eps, theta[None] - sigma * eps])
        fits = evaluate(cand, generator)
        w = centered_ranks(fits)
        grad = (w[:P] - w[P:]) @ eps / (P * sigma)
        theta = theta + learning_rate * grad
        gen_best = fits.max()
        improved = gen_best > best
        sigma = torch.where(improved, sigma, torch.clamp_min(sigma * sigma_decay, sigma_min))
        best = torch.maximum(best, gen_best)
        return (theta, sigma, best), gen_best

    def init_state():
        kw = dict(dtype=theta0.dtype, device=theta0.device)
        return theta0, torch.tensor(noise_std, **kw), torch.tensor(-torch.inf, **kw)

    @torch.no_grad()
    def run_chunk(es_state, n: int, generator: torch.Generator):
        hist = []
        for _ in range(n):
            es_state, gen_best = generation(es_state, generator)
            hist.append(gen_best)
        return es_state, torch.stack(hist)

    return init_state, run_chunk, unravel


def policy_es(generator: torch.Generator, params: dict, fitness_fn: Callable,
              n_perturbations: int = 32, n_iterations: int = 100, noise_std: float = 0.05,
              learning_rate: float = 0.02, common_randomness: bool = True, mesh=None,
              sigma_decay: float = 1.0, sigma_min: float = 1e-3,
              device=None):  # CUDA unless "cpu"
    """NES over a parameter tree for ``n_iterations`` generations (see
    :func:`make_policy_es`). Returns (trained tree, (n_iterations,)
    best-fitness history)."""
    init_state, run_chunk, unravel = make_policy_es(
        params, fitness_fn, n_perturbations=n_perturbations, noise_std=noise_std,
        learning_rate=learning_rate, common_randomness=common_randomness, mesh=mesh,
        sigma_decay=sigma_decay, sigma_min=sigma_min, device=device)
    (theta, _, _), hist = run_chunk(init_state(), n_iterations, generator)
    return unravel(theta), hist
