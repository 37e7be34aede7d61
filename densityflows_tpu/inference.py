"""Inference engine: rejection sampling, SNPE/VI posterior fitting, SMC.

The reference ships only a serial, unexported ``sample_with_rejection``
marked "Need to be checked" (/root/reference/src/Flows.jl:196-229). This
subsystem is the capability *addition* mandated by the north star
(SURVEY.md §2.2 "Sharded-particle inference"): everything is formulated
over a batch/particle axis that shards over the mesh ``data`` axis, so
the same jitted programs scale from one chip to a pod slice with XLA
collectives inserted by GSPMD.

Components:

- :func:`sample_with_rejection` — the reference's accept/reject loop
  re-formulated as a jitted ``lax.while_loop`` over fixed-size draw
  batches with mask-compaction scatter (no dynamic shapes), keeping the
  reference's ``m × n`` attempt cap contract;
- :func:`weighted_nll_loss` / :func:`make_weighted_train_step` —
  importance-weighted NLL for proposal-corrected fitting;
- :func:`fit_posterior` — SNPE-style amortized posterior fit
  q(θ | x): conditional MLE on simulator pairs, with optional importance
  weights prior/proposal (SNPE-B correction);
- :func:`fit_variational` — reverse-KL variational fit of the flow to an
  unnormalized log-density (VI), one fused jitted program over steps;
- :func:`effective_sample_size`, :func:`systematic_resample`,
  :func:`smc_step`, :func:`run_smc` — tempered SMC over sharded
  particles: reweight → ESS-triggered systematic resampling (prefix-sum
  formulation) → random-walk MH move, all inside ``lax`` control flow.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .models.flow import Flow

__all__ = [
    "sample_with_rejection",
    "weighted_nll_loss",
    "make_weighted_train_step",
    "fit_posterior",
    "fit_posterior_apt",
    "apt_loss",
    "fit_posterior_rounds",
    "propose_from_posterior",
    "fit_variational",
    "effective_sample_size",
    "systematic_resample",
    "SMCState",
    "smc_step",
    "run_smc",
    "flow_mcmc",
    "mcmc_diagnostics",
    "sbc_ranks",
    "sbc_uniformity",
    "clear_caches",
]


# -- identity-checked program caches -----------------------------------------
#
# Every engine entry point compiles its whole run as ONE program; defining
# the @jax.jit closure inside the function body would recompile per CALL
# (the jit cache keys on the closure object). These caches hoist each
# program: the static config is the dict key and the entry stores the
# keyed Python objects themselves, so (a) their id()s stay alive — a GC'd
# callable could otherwise hand its id to a new object and silently reuse
# a stale program capturing the OLD closure — and (b) hits are verified
# by identity, making collisions impossible rather than merely unlikely
# (the train.py / _VI_CACHE doctrine, train.py:204-212).

# program-name → number of times its body was TRACED (Python side effect
# at trace time only); tests assert a second identically-configured call
# performs no retrace
trace_counts: dict[str, int] = {}


def _count_trace(name: str) -> None:
    trace_counts[name] = trace_counts.get(name, 0) + 1


class _IdentityCache:
    """static-key → (identity objects, program), hit only when every
    keyed object is the SAME object that built the program."""

    def __init__(self):
        self._store: dict = {}

    def get(self, static_key, identity_objs: tuple):
        entry = self._store.get(static_key)
        if entry is not None and len(entry[0]) == len(identity_objs) and all(
            a is b for a, b in zip(entry[0], identity_objs)
        ):
            return entry[1]
        return None

    def put(self, static_key, identity_objs: tuple, program):
        self._store[static_key] = (tuple(identity_objs), program)
        return program


_REJECTION_CACHE = _IdentityCache()
_MCMC_CACHE = _IdentityCache()
_SMC_CACHE = _IdentityCache()


def clear_caches() -> None:
    """Drop every id-keyed compiled-program cache (inference + train).

    The engine caches whole-run programs keyed on the IDENTITY of the
    Python objects that configure them (optimizer / log-density
    instances), and entries live forever: a long-lived process sweeping
    many distinct targets or optimizers accumulates programs. Calling
    this releases them all (and XLA's own executable references with
    them). Existing flows keep working — the next engine call simply
    re-traces. ``trace_counts`` is left intact (it is a diagnostic
    counter, not a cache).
    """
    # NOT `from . import train` — the package re-exports the train()
    # FUNCTION under that name, shadowing the module attribute
    from .train import _PROGRAM_CACHE

    _PROGRAM_CACHE.clear()
    _VI_CACHE.clear()
    _APT_CACHE._store.clear()
    for c in (_REJECTION_CACHE, _MCMC_CACHE, _SMC_CACHE):
        c._store.clear()


def _particle_sharding(mesh):
    if mesh is None:
        return None
    from .parallel.mesh import data_sharding

    return data_sharding(mesh, 2)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _sharded_normal(key, n, d, sharding):
    return jax.lax.with_sharding_constraint(
        jax.random.normal(key, (n, d)), sharding
    )


# -- rejection sampling -----------------------------------------------------


def sample_with_rejection(
    flow: Flow,
    n_samples: int,
    condition: Callable[[jax.Array], jax.Array],
    theta=None,
    *,
    key=None,
    max_rounds: int = 100,
    batch: int | None = None,
    dtype=jnp.float32,
    mesh=None,
):
    """Draw ``n_samples`` samples satisfying ``condition(x) -> bool mask``.

    Vectorized replacement for the reference's serial accept/reject loop
    (src/Flows.jl:196-229, attempt cap ``m·n`` → here ``max_rounds``
    fixed-size rounds): a ``lax.while_loop`` draws ``batch`` candidates per
    round, transforms them through the flow's jitted sampling program, and
    compacts accepted rows into the output buffer with a cumsum+scatter
    (static shapes throughout — TPU-friendly, no host sync per round).
    Under ``mesh`` the candidate-draw axis is sharded over ``data`` like
    every other particle subsystem (SMC/MCMC/sweep).

    The program is compiled once per (condition, shape config) and cached
    by identity — repeated calls with the same configuration dispatch the
    cached executable (no retrace).

    Raises ``RuntimeError`` if the cap is hit before ``n_samples`` are
    accepted (reference throws ArgumentError, src/Flows.jl:220-223).
    """
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))
    if batch is None:
        batch = max(2 * n_samples, 1024)
    theta_n = flow.prepare_theta(theta, (batch,), dtype)
    sharding = _particle_sharding(mesh)

    cache_key = (id(condition), n_samples, max_rounds, batch,
                 jnp.dtype(dtype).name, sharding)
    run = _REJECTION_CACHE.get(cache_key, (condition,))
    if run is None:

        @jax.jit
        def run(model, base, theta_n, key):
            _count_trace("rejection")

            def constrain(a):
                if sharding is not None:
                    return jax.lax.with_sharding_constraint(a, sharding)
                return a

            def cond_fn(carry):
                filled, _, _, rounds = carry
                return jnp.logical_and(filled < n_samples,
                                       rounds < max_rounds)

            def body_fn(carry):
                filled, out, k, rounds = carry
                k, k_draw = jax.random.split(k)
                r = constrain(base.sample(k_draw, (batch,), dtype))
                x = model.forward_(r, theta_n)
                ok = condition(x).astype(jnp.int32).reshape(batch)
                # compaction: accepted row j goes to slot filled + rank(j)
                ranks = jnp.cumsum(ok) - 1
                dest = jnp.where(ok == 1, filled + ranks, n_samples)  # drop
                out = out.at[dest].set(x, mode="drop")
                return filled + jnp.sum(ok), out, k, rounds + 1

            out0 = jnp.zeros((n_samples, base.d), dtype)
            filled, out, _, rounds = jax.lax.while_loop(
                cond_fn, body_fn, (jnp.int32(0), out0, key, jnp.int32(0))
            )
            return filled, out, rounds

        _REJECTION_CACHE.put(cache_key, (condition,), run)

    filled, out, rounds = run(flow.model, flow.base, theta_n, key)
    filled = int(filled)
    if filled < n_samples:
        raise RuntimeError(
            f"rejection sampling accepted only {filled}/{n_samples} draws "
            f"after {int(rounds)} rounds of {batch} "
            "(reference convergence-cap contract, src/Flows.jl:220-223)"
        )
    return out


# -- importance-weighted NLL ------------------------------------------------


def weighted_nll_loss(model, base, x, theta, weights):
    """−Σ wᵢ·log p(xᵢ|θᵢ) / Σ wᵢ — importance-weighted forward-KL NLL.

    With ``weights = prior(θ)/proposal(θ)`` this is the SNPE-B correction;
    with uniform weights it reduces to the reference loss
    (src/Flows.jl:352-359)."""
    z, ldj = model.inverse(x, theta)
    per_sample = base.log_prob(z) + ldj
    w = weights.astype(jnp.float32)
    return -jnp.sum(per_sample * w) / jnp.maximum(jnp.sum(w), 1e-30)


def make_weighted_train_step(optimizer):
    """Fused loss+grad+update step for :func:`weighted_nll_loss` (the
    weighted analogue of ``train.make_train_step``)."""

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(model, opt_state, base, x, theta, weights):
        loss, grads = jax.value_and_grad(weighted_nll_loss)(
            model, base, x, theta, weights
        )
        updates, opt_state = optimizer.update(grads, opt_state, model)
        model = optax.apply_updates(model, updates)
        return model, opt_state, loss

    return step


# -- SNPE-style amortized posterior fit -------------------------------------


def fit_posterior(
    flow: Flow,
    theta_samples,
    x_observations,
    *,
    weights=None,
    optimizer=None,
    epochs: int = 100,
    batchsize: int = 64,
    key=None,
    mesh=None,
    verbose: bool = False,
):
    """Fit the flow as an amortized posterior q(θ | x) by conditional MLE.

    SNPE round 1: train on simulator pairs (θᵢ ~ prior, xᵢ ~ sim(θᵢ));
    the flow's *data* axis models θ and its *condition* axis models x.
    Pass ``weights = prior(θᵢ)/proposal(θᵢ)`` when θ was drawn from a
    proposal instead of the prior (SNPE-B importance correction). Both
    paths run the SAME fused multi-epoch program in ``train`` (weights
    thread through as a generalized loss mask), so weighted and
    unweighted fits share the program cache and both keep the
    reference's full-split per-epoch loss histories — the weighted
    histories are weighted NLLs.

    No reference counterpart — capability addition per SURVEY.md §2.2.
    """
    from .data import DataArrays
    from .train import train

    theta_samples = np.asarray(theta_samples, np.float32)
    x_observations = np.asarray(x_observations, np.float32)
    data = DataArrays.make(theta_samples, x_observations, rng=0)

    return train(
        flow, data, optimizer, epochs=epochs, batchsize=batchsize,
        key=key, mesh=mesh, verbose=verbose, weights=weights,
    )


def propose_from_posterior(
    flow,
    x_obs,
    n: int,
    prior_sample: Callable[[np.random.Generator, int], np.ndarray],
    prior_log_prob: Callable[[np.ndarray], np.ndarray],
    rng: np.random.Generator,
    key,
    *,
    n_eps_min: int = 4096,
):
    """Draw n proposal θ from the posterior estimate q(θ | x_obs), with
    prior-support fallback, and return (θ, log q̃(θ)) under the TRUE
    proposal density.

    Mechanism: θ ~ flow; if θ lands outside the prior support
    (``prior_log_prob = −inf``) it is replaced by a prior draw. The
    density of this mechanism at in-support θ is the mixture

        q̃(θ) = q_flow(θ) + ε·prior(θ),   ε = P_flow(draw ∉ support)

    (the kept-flow branch contributes its unnormalized density q_flow
    directly — note (1−ε)·q_trunc = q_flow — and the replacement branch
    contributes ε·prior). Evaluating q_flow alone at replaced θ biases
    SNPE-B importance weights exactly when truncation matters
    (tested: tests/test_snpe_rounds.py). ε is estimated from an
    independent batch of ≥ ``n_eps_min`` flow draws, add-one smoothed
    (replacement occurred, so ε > 0 is known).
    """
    x_obs = np.asarray(x_obs, np.float32).reshape(-1)
    cond = tuple(x_obs)
    draws = np.asarray(flow.sample((n,), cond, key=key), np.float32)
    lp_prior = np.asarray(prior_log_prob(draws), np.float64)
    bad = ~np.isfinite(lp_prior)
    if bad.any():
        draws[bad] = np.asarray(prior_sample(rng, int(bad.sum())), np.float32)
    theta = draws
    cond_b = np.broadcast_to(x_obs, (len(theta), x_obs.shape[0]))
    log_q_flow = np.asarray(
        flow.log_prob(jnp.asarray(theta), cond_b), np.float64
    )
    if not bad.any():
        return theta, log_q_flow
    n_eps = max(n, n_eps_min)
    k_eps = jax.random.fold_in(key, 0xE95)
    eps_draws = np.asarray(flow.sample((n_eps,), cond, key=k_eps), np.float32)
    n_bad = int(
        (~np.isfinite(np.asarray(prior_log_prob(eps_draws), np.float64))).sum()
    )
    eps = max(n_bad, 1) / (n_eps + 1)
    log_q = np.logaddexp(
        log_q_flow,
        np.log(eps) + np.asarray(prior_log_prob(theta), np.float64),
    )
    return theta, log_q


def fit_posterior_rounds(
    flow: Flow,
    simulator: Callable[[np.ndarray], np.ndarray],
    prior_sample: Callable[[np.random.Generator, int], np.ndarray],
    prior_log_prob: Callable[[np.ndarray], np.ndarray],
    x_obs,
    *,
    n_rounds: int = 3,
    n_sims_per_round: int = 1000,
    optimizer=None,
    epochs: int = 50,
    batchsize: int = 64,
    key=None,
    rng=None,
    verbose: bool = False,
    method: str = "snpe_b",
    n_atoms: int = 10,
):
    """Sequential (multi-round) SNPE: simulate → fit → propose, focused on
    one observation ``x_obs``.

    ``method``: ``"snpe_b"`` (default — importance-weighted NLL with the
    exact mixture proposal density) or ``"apt"`` (SNPE-C atomic loss,
    :func:`fit_posterior_apt` with ``n_atoms`` — proposal-robust, no
    importance weights; the per-round history reports the atom-pool ESS
    as ``None``).

    Round 1 draws θ from the prior; later rounds draw from the CURRENT
    posterior estimate q(θ | x_obs) (the proposal), correcting the NLL
    with SNPE-B importance weights w = p(θ)/q̃(θ | x_obs) so the fit
    still targets the true posterior. Proposal densities come from the
    flow itself (``log_prob``), so no auxiliary density estimator is
    needed. Simulation happens on the host (``simulator`` is arbitrary
    user code); fitting is the fused/jitted path of
    :func:`fit_posterior`.

    Prior-support rejection is density-corrected: flow draws that land
    outside the prior support (``prior_log_prob = −inf``) are replaced by
    prior draws, which makes the TRUE proposal the mixture
    ``q̃(θ) = q_flow(θ) + ε·prior(θ)`` with ε = P_flow(draw ∉ support)
    (the in-support flow branch contributes its unnormalized density
    q_flow directly; the replacement branch contributes ε·prior). The
    importance weights use exactly this mixture — evaluating q_flow alone
    at replaced θ (the naive formula) biases the weights whenever
    truncation is frequent. ε is estimated from an independent batch of
    flow draws so the estimate is decorrelated from the training θ.

    Returns ``(flow, history)`` where history records per-round sim
    counts and ESS of the importance weights. No reference counterpart —
    the reference has no inference engine at all (SURVEY.md §2.2).
    """
    if method not in ("snpe_b", "apt"):
        raise ValueError("method must be 'snpe_b' or 'apt'")
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))
    if rng is None:
        rng = np.random.default_rng(0)
    x_obs = np.asarray(x_obs, np.float32).reshape(-1)

    all_theta: list[np.ndarray] = []
    all_x: list[np.ndarray] = []
    all_logq: list[np.ndarray] = []  # log proposal density at each θ
    history = []

    for rnd in range(n_rounds):
        key, k_fit, k_prop = jax.random.split(key, 3)
        if rnd == 0:
            theta = np.asarray(prior_sample(rng, n_sims_per_round), np.float32)
            log_q = np.asarray(prior_log_prob(theta), np.float64)
        else:
            theta, log_q = propose_from_posterior(
                flow, x_obs, n_sims_per_round, prior_sample,
                prior_log_prob, rng, k_prop,
            )
        x_sim = np.asarray(simulator(theta), np.float32)
        if x_sim.shape[0] != theta.shape[0]:
            raise ValueError("simulator must return one row per θ")

        all_theta.append(theta)
        all_x.append(x_sim)
        all_logq.append(log_q)

        theta_cat = np.concatenate(all_theta)
        x_cat = np.concatenate(all_x)

        if method == "apt":
            fit_posterior_apt(
                flow, theta_cat, x_cat, prior_log_prob,
                n_atoms=n_atoms, optimizer=optimizer, epochs=epochs,
                batchsize=batchsize, key=k_fit, verbose=False,
            )
            ess = None
        else:
            log_p = np.asarray(prior_log_prob(theta_cat), np.float64)
            log_w = log_p - np.concatenate(all_logq)
            log_w -= log_w.max()
            w = np.exp(log_w).astype(np.float32)
            w /= w.mean()
            ess = float(w.sum() ** 2 / (w * w).sum())

            fit_posterior(
                flow, theta_cat, x_cat, weights=w if rnd > 0 else None,
                optimizer=optimizer, epochs=epochs, batchsize=batchsize,
                key=k_fit, verbose=False,
            )
        history.append({"round": rnd + 1, "n_sims": int(len(theta_cat)),
                        "weight_ess": ess})
        if verbose:
            tag = "atomic" if method == "apt" else f"weight ESS {ess:.1f}"
            print(f"round {rnd + 1}: {len(theta_cat)} sims, {tag}, "
                  f"loss {flow.train_loss[-1]:.4f}")
    return flow, history


# -- SNPE-C / APT (atomic posterior transformation) ---------------------------


_APT_CACHE = _IdentityCache()


def apt_loss(model, base, theta_b, x_b, log_prior_b, atom_idx):
    """Atomic SNPE-C loss (Greenberg et al. 2019): for each example i with
    atom set A(i) (its own θ first),

        −log softmax over m ∈ A(i) of [ log q(θ_m | x_i) − log p(θ_m) ]
        evaluated at m = i

    — classify the true θ against contrastive atoms under the
    PRIOR-CORRECTED density ratio q/p. The −log p(θ_m) term is what makes
    the optimum the true posterior: atoms drawn from any pool p̃ give the
    Bayes-optimal softmax logits log p(θ|x) − log p̃(θ), so matching them
    with log q − log p lands q = posterior (dropping the term — valid
    only for uniform priors — lands q ∝ likelihood instead; caught by the
    conjugate-Gaussian test). Because the pool density cancels in the
    softmax, multi-round fits need NO importance weights (the SNPE-B
    alternative). ``atom_idx`` (B, M) rows index into the batch; column 0
    must be ``arange(B)``.
    """
    b, m = atom_idx.shape
    theta_atoms = theta_b[atom_idx].reshape(b * m, theta_b.shape[-1])
    x_rep = jnp.repeat(x_b, m, axis=0)
    z, ldj = model.inverse(theta_atoms, x_rep)
    lq = (base.log_prob(z) + ldj).reshape(b, m) - log_prior_b[atom_idx]
    return -jnp.mean(lq[:, 0] - jax.scipy.special.logsumexp(lq, axis=1))


def _atom_indices(key, b, n_atoms):
    """(B, M) atom index rows: column 0 = self, columns 1..M−1 drawn
    WITHOUT replacement from the other B−1 examples of the batch."""
    self_idx = jnp.arange(b)

    def row(k, i):
        others = jax.random.choice(k, b - 1, (n_atoms - 1,), replace=False)
        return jnp.concatenate(
            [i[None], jnp.where(others >= i, others + 1, others)]
        )

    return jax.vmap(row)(jax.random.split(key, b), self_idx)


def fit_posterior_apt(
    flow: Flow,
    theta_samples,
    x_observations,
    prior_log_prob: Callable[[np.ndarray], np.ndarray] | None = None,
    *,
    n_atoms: int = 10,
    optimizer=None,
    epochs: int = 100,
    batchsize: int = 64,
    key=None,
    verbose: bool = False,
):
    """Fit the flow as an amortized posterior q(θ | x) with the atomic
    SNPE-C/APT objective — the proposal-robust alternative to
    :func:`fit_posterior`'s SNPE-B weights: θ drawn from ANY proposal
    (prior round 1, the current posterior later) trains correctly because
    the atom-pool density cancels in the atomic softmax.

    ``prior_log_prob(θ) -> (n,)`` evaluates the PRIOR density at the raw
    θ rows (the q/p correction inside :func:`apt_loss`); ``None`` means a
    uniform/improper-flat prior (the term is constant and drops out).

    One fused multi-epoch program (scan over epochs → scan over batches;
    fresh atom draw per batch; per-epoch mean atomic loss appended to
    ``flow.train_loss``), cached by identity like every other engine
    program. Returns ``opt_state``.
    """
    from .train import _default_adam

    if optimizer is None:
        optimizer = _default_adam()
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))
    theta_samples = np.asarray(theta_samples, np.float32)
    x_observations = np.asarray(x_observations, np.float32)
    n = theta_samples.shape[0]
    if x_observations.shape[0] != n:
        raise ValueError("theta and x must have the same number of rows")
    if not 2 <= n_atoms <= batchsize:
        raise ValueError(f"need 2 <= n_atoms <= batchsize, got {n_atoms}")
    n_batches = n // batchsize  # APT drops the ragged tail batch: atoms
    if n_batches == 0:          # must come from a full batch
        raise ValueError(
            f"need at least one full batch ({batchsize}) of simulations, "
            f"got {n}"
        )

    # the posterior flow's DATA axis is θ and its CONDITION is x — so the
    # boundary normalization applies to x, via the flow's metadata (the
    # same contract train() applies through DataArrays in fit_posterior)
    from .data import normalize_input

    if flow.metadata.n:
        x_n = np.asarray(normalize_input(
            x_observations,
            np.asarray(flow.metadata.theta_min),
            np.asarray(flow.metadata.theta_max),
        ), np.float32)
    else:
        x_n = x_observations

    if prior_log_prob is None:
        log_p = np.zeros((n,), np.float32)
    else:
        log_p = np.asarray(prior_log_prob(theta_samples),
                           np.float32).reshape(n)
        if not np.isfinite(log_p).all():
            raise ValueError(
                "prior_log_prob must be finite at every simulated θ "
                "(out-of-support rows cannot train the atomic loss)"
            )

    cache_key = (id(optimizer), n, batchsize, epochs, n_atoms)
    program = _APT_CACHE.get(cache_key, (optimizer,))
    if program is None:

        @partial(jax.jit, donate_argnums=(0, 1))
        def program(model, opt_state, base, th, x, log_p, key):
            _count_trace("apt")

            def epoch_body(carry, ekey):
                model, opt_state = carry
                k_perm, k_atoms = jax.random.split(ekey)
                perm = jax.random.permutation(k_perm, n).astype(jnp.int32)
                idx = perm[: n_batches * batchsize].reshape(
                    n_batches, batchsize)

                def batch_body(carry, inp):
                    model, opt_state = carry
                    bi, k = inp
                    atom_idx = _atom_indices(k, batchsize, n_atoms)
                    loss, grads = jax.value_and_grad(apt_loss)(
                        model, base, th[bi], x[bi], log_p[bi], atom_idx
                    )
                    updates, opt_state = optimizer.update(
                        grads, opt_state, model)
                    model = optax.apply_updates(model, updates)
                    return (model, opt_state), loss

                (model, opt_state), losses = jax.lax.scan(
                    batch_body, (model, opt_state),
                    (idx, jax.random.split(k_atoms, n_batches)),
                )
                return (model, opt_state), jnp.mean(losses)

            keys = jax.random.split(key, epochs)
            (model, opt_state), epoch_losses = jax.lax.scan(
                epoch_body, (model, opt_state), keys
            )
            return model, opt_state, epoch_losses

        _APT_CACHE.put(cache_key, (optimizer,), program)

    model = flow.model
    opt_state = optimizer.init(model)
    model, opt_state, losses = program(
        model, opt_state, flow.base, jnp.asarray(theta_samples),
        jnp.asarray(x_n), jnp.asarray(log_p), key,
    )
    losses = np.asarray(losses)
    flow.model = model
    flow.train_loss.extend(float(v) for v in losses)
    if verbose:
        print(f"APT: {epochs} epochs, final atomic loss {losses[-1]:.4f}")
    return opt_state


# -- variational (reverse-KL) fit -------------------------------------------


_VI_CACHE: dict = {}


def fit_variational(
    flow: Flow,
    log_density: Callable[[jax.Array], jax.Array],
    *,
    theta=None,
    optimizer=None,
    steps: int = 1000,
    n_particles: int = 1024,
    key=None,
    mesh=None,
    verbose: bool = False,
):
    """Variational fit: minimize KL(q_flow ‖ p) for unnormalized log p.

    loss = E_{z~base}[ log q(x) − log p̃(x) ],  x = flow.forward(z),
    log q(x) = base.log_prob(z) − ldj_forward — the reparameterized
    reverse-KL objective, run as ONE fused jitted program scanning over
    ``steps`` (same program-shape philosophy as ``train``).

    Appends per-step losses to ``flow.train_loss``. No reference
    counterpart — capability addition per SURVEY.md §2.2.
    """
    from .train import _default_adam

    if optimizer is None:
        optimizer = _default_adam()
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))
    theta_n = flow.prepare_theta(theta, (n_particles,))
    base = flow.base

    particle_sharding = None
    if mesh is not None:
        from .parallel.mesh import data_sharding

        particle_sharding = data_sharding(mesh, 2)

    cache_key = (id(optimizer), id(log_density), steps, n_particles,
                 particle_sharding)
    cached = _VI_CACHE.get(cache_key)
    # identity-checked: entries hold the keyed objects so their id()s
    # stay alive — otherwise a GC'd optimizer/log_density could hand its
    # id to a new object and silently reuse a stale compiled program
    # capturing the OLD closure
    if cached is not None and cached[0] is optimizer and cached[1] is log_density:
        program = cached[2]
    else:

        def vi_loss(model, k):
            z = base.sample(k, (n_particles,))
            if particle_sharding is not None:
                z = jax.lax.with_sharding_constraint(z, particle_sharding)
            x, ldj = model.forward(z, theta_n)
            log_q = base.log_prob(z) - ldj
            return jnp.mean(log_q - log_density(x))

        @partial(jax.jit, donate_argnums=(0, 1))
        def program(model, opt_state, key):
            def body(carry, k):
                model, opt_state = carry
                loss, grads = jax.value_and_grad(vi_loss)(model, k)
                updates, opt_state = optimizer.update(grads, opt_state, model)
                model = optax.apply_updates(model, updates)
                return (model, opt_state), loss

            keys = jax.random.split(key, steps)
            (model, opt_state), losses = jax.lax.scan(
                body, (model, opt_state), keys
            )
            return model, opt_state, losses

        _VI_CACHE[cache_key] = (optimizer, log_density, program)

    model = flow.model
    opt_state = optimizer.init(model)
    model, opt_state, losses = program(model, opt_state, key)
    losses = np.asarray(losses)
    flow.model = model
    flow.train_loss.extend(float(v) for v in losses)
    if verbose:
        print(f"VI: {steps} steps, final loss {losses[-1]:.4f}")
    return opt_state


# -- SMC over sharded particles ---------------------------------------------


def effective_sample_size(log_weights):
    """ESS = (Σw)²/Σw² from log-weights, numerically stable."""
    lw = log_weights - jnp.max(log_weights)
    w = jnp.exp(lw)
    return jnp.square(jnp.sum(w)) / jnp.sum(w * w)


def systematic_resample(log_weights, key):
    """Systematic resampling: returns ancestor indices, shape like weights.

    Prefix-sum formulation (SURVEY.md §7 hard parts): normalized-weight
    cumsum + one stratified uniform grid + ``searchsorted``. All ops are
    collective-friendly — under a sharded particle axis XLA lowers the
    cumsum to a log-depth scan and the gather to an all_gather-free
    permute when the mesh layout allows.
    """
    n = log_weights.shape[0]
    lw = log_weights - jax.scipy.special.logsumexp(log_weights)
    cdf = jnp.cumsum(jnp.exp(lw))
    cdf = cdf / cdf[-1]  # kill accumulation error at the top
    u0 = jax.random.uniform(key, ())
    grid = (u0 + jnp.arange(n, dtype=jnp.float32)) / n
    return jnp.clip(jnp.searchsorted(cdf, grid, side="left"), 0, n - 1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SMCState:
    """Particles + log-weights + cached log-densities at the particles."""

    particles: jax.Array  # (n, d)
    log_weights: jax.Array  # (n,)
    log_prior: jax.Array  # (n,) cached log q0 (the init density)
    log_target: jax.Array  # (n,) cached log p̃ (unnormalized target)


def smc_step(
    state: SMCState,
    log_density: Callable[[jax.Array], jax.Array],
    log_prior: Callable[[jax.Array], jax.Array],
    lam_old,
    lam_new,
    key,
    *,
    ess_threshold: float = 0.5,
    mh_step_size: float = 0.1,
    n_mh: int = 1,
):
    """One tempered-SMC step on the ladder π_λ ∝ q0^(1−λ)·p̃^λ.

    Reweight by ``(p̃/q0)^Δλ``, resample if ESS < threshold·n, then
    ``n_mh`` random-walk Metropolis moves targeting π_{λ_new} — so at
    λ=0 the particles are exactly q0-distributed and at λ=1 exactly p̃.
    Jit-traceable; compose with ``lax.scan`` over a λ-ladder (``run_smc``).
    """
    n = state.particles.shape[0]
    dlam = lam_new - lam_old
    log_w = state.log_weights + dlam * (state.log_target - state.log_prior)
    ess = effective_sample_size(log_w)
    k_res, k_mh = jax.random.split(key)

    def do_resample(_):
        idx = systematic_resample(log_w, k_res)
        return (
            state.particles[idx],
            jnp.zeros((n,), jnp.float32),
            state.log_prior[idx],
            state.log_target[idx],
        )

    def no_resample(_):
        return state.particles, log_w, state.log_prior, state.log_target

    particles, log_w, log_q0, log_tgt = jax.lax.cond(
        ess < ess_threshold * n, do_resample, no_resample, None
    )

    # MH moves targeting π_{λ_new} ∝ q0^(1−λ)·p̃^λ
    def mh_body(carry, k):
        x, lq, lp = carry
        k1, k2 = jax.random.split(k)
        prop = x + mh_step_size * jax.random.normal(k1, x.shape, x.dtype)
        lq_prop = log_prior(prop)
        lp_prop = log_density(prop)
        log_alpha = (1.0 - lam_new) * (lq_prop - lq) + lam_new * (lp_prop - lp)
        accept = jnp.log(jax.random.uniform(k2, lp.shape)) < log_alpha
        x = jnp.where(accept[..., None], prop, x)
        lq = jnp.where(accept, lq_prop, lq)
        lp = jnp.where(accept, lp_prop, lp)
        return (x, lq, lp), jnp.mean(accept.astype(jnp.float32))

    (particles, log_q0, log_tgt), acc = jax.lax.scan(
        mh_body, (particles, log_q0, log_tgt), jax.random.split(k_mh, n_mh)
    )
    return SMCState(particles, log_w, log_q0, log_tgt), ess, jnp.mean(acc)


def run_smc(
    log_density: Callable[[jax.Array], jax.Array],
    d: int,
    n_particles: int = 4096,
    *,
    n_steps: int = 20,
    init_scale: float = 1.0,
    key=None,
    ess_threshold: float = 0.5,
    mh_step_size: float = 0.1,
    n_mh: int = 2,
    mesh=None,
):
    """Tempered SMC from q0 = N(0, init_scale²·I) to exp(log_density),
    annealing π_λ ∝ q0^(1−λ)·p̃^λ.

    One fused jitted program: ``lax.scan`` over a linear λ-ladder of
    :func:`smc_step`. Under ``mesh`` the particle axis is sharded over
    ``data`` (the 10M-draws/s particle-collective path, SURVEY.md §5).
    Returns (particles, log_weights, diagnostics dict).
    """
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))
    k_init, k_run = jax.random.split(key)
    sharding = _particle_sharding(mesh)
    if sharding is not None:
        # draw ON the mesh (module-level cached program with an in-program
        # sharding constraint) — a device_put of an eager host-local array
        # would fail on a multi-process mesh
        x0 = init_scale * _sharded_normal(k_init, n_particles, d, sharding)
    else:
        x0 = init_scale * jax.random.normal(k_init, (n_particles, d))

    cache_key = (id(log_density), d, n_particles, n_steps,
                 float(init_scale), float(ess_threshold),
                 float(mh_step_size), n_mh, sharding)
    program = _SMC_CACHE.get(cache_key, (log_density,))
    if program is None:

        def log_prior(x):
            return -0.5 * jnp.sum(x * x, axis=-1) / (init_scale**2)

        lams = jnp.linspace(0.0, 1.0, n_steps + 1)

        @jax.jit
        def program(x0, key):
            _count_trace("smc")
            state = SMCState(
                x0, jnp.zeros((n_particles,), jnp.float32),
                log_prior(x0), log_density(x0),
            )

            def body(state, inp):
                lam_old, lam_new, k = inp
                state, ess, acc = smc_step(
                    state, log_density, log_prior, lam_old, lam_new, k,
                    ess_threshold=ess_threshold,
                    mh_step_size=mh_step_size, n_mh=n_mh,
                )
                return state, (ess, acc)

            keys = jax.random.split(key, n_steps)
            state, (ess_hist, acc_hist) = jax.lax.scan(
                body, state, (lams[:-1], lams[1:], keys)
            )
            return state, ess_hist, acc_hist

        _SMC_CACHE.put(cache_key, (log_density,), program)

    state, ess_hist, acc_hist = program(x0, k_run)
    return state.particles, state.log_weights, {
        "ess": ess_hist, "mh_accept": acc_hist,
    }


# -- flow-accelerated MCMC --------------------------------------------------


def flow_mcmc(
    flow: Flow,
    log_density: Callable[[jax.Array], jax.Array],
    *,
    theta=None,
    n_chains: int = 256,
    n_steps: int = 1000,
    burn_in: int = 100,
    method: str = "independence",
    step_size: float = 0.2,
    key=None,
    mesh=None,
):
    """MCMC targeting exp(log_density) with the trained flow as transport.

    Two standard flow-accelerated kernels, both as ONE jitted
    ``lax.scan`` over vectorized chains (the chain axis shards over the
    mesh ``data`` axis like any particle axis):

    - ``method='independence'``: independence Metropolis-Hastings —
      proposals are fresh flow samples, accepted with
      min(1, p(x')q(x)/(p(x)q(x'))). Exact even when the flow fit is
      imperfect; acceptance rate measures fit quality.
    - ``method='neutra'``: NeuTra-style preconditioning (Hoffman et al.
      2019) — random-walk MH in the flow's LATENT space on the pulled-
      back target log p(f(z)) + ldj_f(z), where the geometry is near-
      isotropic if the flow fit the target.

    Returns ``(samples, diagnostics)`` with samples of shape
    ``(n_steps - burn_in, n_chains, d)`` and diagnostics carrying the
    per-step mean acceptance plus convergence checks (``r_hat``/``ess``
    from :func:`mcmc_diagnostics`, when ≥ 4 steps are kept). No
    reference counterpart (its only sampler is serial rejection,
    src/Flows.jl:196-229).
    """
    if method not in ("independence", "neutra"):
        raise ValueError("method must be 'independence' or 'neutra'")
    if not 0 <= burn_in < n_steps:
        raise ValueError(f"need 0 <= burn_in < n_steps, got {burn_in}/{n_steps}")
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))
    theta_n = flow.prepare_theta(theta, (n_chains,))
    model, base = flow.model, flow.base

    chain_sharding = _particle_sharding(mesh)

    cache_key = (id(log_density), n_chains, n_steps, method,
                 float(step_size), chain_sharding)
    def _result(xs, acc):
        kept = xs[burn_in:]
        diag = {"accept_rate": acc, "burn_in": burn_in}
        if kept.shape[0] >= 4:  # split-R̂/ESS need a few kept steps
            diag.update(mcmc_diagnostics(kept))
        return kept, diag

    program = _MCMC_CACHE.get(cache_key, (log_density,))
    if program is not None:
        xs, acc = program(model, base, theta_n, key)
        return _result(xs, acc)

    def constrain(a):
        if chain_sharding is not None:
            return jax.lax.with_sharding_constraint(a, chain_sharding)
        return a

    @jax.jit
    def program(model, base, theta_n, key):
        _count_trace("mcmc")
        k_init, k_run = jax.random.split(key)
        z0 = constrain(base.sample(k_init, (n_chains,)))
        x0, ldj0 = model.forward(z0, theta_n)

        if method == "independence":
            # state: x, log p̃(x), log q(x)
            state0 = (x0, log_density(x0), base.log_prob(z0) - ldj0)

            def body(state, k):
                x, lp, lq = state
                k1, k2 = jax.random.split(k)
                z_p = constrain(base.sample(k1, (n_chains,)))
                x_p, ldj_p = model.forward(z_p, theta_n)
                lp_p = log_density(x_p)
                lq_p = base.log_prob(z_p) - ldj_p
                log_alpha = (lp_p - lq_p) - (lp - lq)
                accept = jnp.log(jax.random.uniform(k2, lp.shape)) < log_alpha
                x = jnp.where(accept[..., None], x_p, x)
                lp = jnp.where(accept, lp_p, lp)
                lq = jnp.where(accept, lq_p, lq)
                return (x, lp, lq), (x, jnp.mean(accept.astype(jnp.float32)))

        else:  # neutra: RW on the pulled-back target in latent space

            def pullback(z):
                x, ldj = model.forward(z, theta_n)
                return x, log_density(x) + ldj

            x0p, lp0 = pullback(z0)
            state0 = (z0, x0p, lp0)

            def body(state, k):
                z, x, lp = state
                k1, k2 = jax.random.split(k)
                z_p = z + step_size * jax.random.normal(k1, z.shape, z.dtype)
                x_p, lp_p = pullback(z_p)
                accept = jnp.log(jax.random.uniform(k2, lp.shape)) < lp_p - lp
                z = jnp.where(accept[..., None], z_p, z)
                x = jnp.where(accept[..., None], x_p, x)
                lp = jnp.where(accept, lp_p, lp)
                return (z, x, lp), (x, jnp.mean(accept.astype(jnp.float32)))

        _, (xs, acc) = jax.lax.scan(body, state0, jax.random.split(k_run, n_steps))
        return xs, acc

    _MCMC_CACHE.put(cache_key, (log_density,), program)
    xs, acc = program(model, base, theta_n, key)
    return _result(xs, acc)


def mcmc_diagnostics(samples):
    """Split-R̂ and effective sample size from ``(steps, chains, d)`` draws.

    The standard convergence checks to run before trusting MCMC output
    (Gelman et al., BDA3 §11.4–11.5; Vehtari et al. 2021 split-chain
    form — the same estimators Stan reports):

    - ``r_hat``: (d,) split-chain potential-scale-reduction. Each chain
      is split in half (catching within-chain drift that whole-chain R̂
      misses); R̂ ≈ 1.00 for mixed chains, > 1.01 flags non-convergence.
    - ``ess``: (d,) combined effective sample size across all chains,
      from FFT autocovariances averaged over chains with Geyer
      initial-positive-sequence truncation.

    Pure host-side numpy on the returned samples (no device work).
    """
    s = np.asarray(samples, np.float64)
    if s.ndim != 3:
        raise ValueError(f"need (steps, chains, d) samples, got {s.shape}")
    n, m, d = s.shape
    if n < 4:
        raise ValueError(f"need >= 4 post-burn-in steps for split-R̂, got {n}")
    half = n // 2
    sp = np.concatenate([s[:half], s[n - half:]], axis=1)  # (half, 2m, d)
    cn, cm = sp.shape[0], sp.shape[1]
    means = sp.mean(axis=0)                                # (2m, d)
    vars_ = sp.var(axis=0, ddof=1)
    w = vars_.mean(axis=0)                                 # within-chain
    b = cn * means.var(axis=0, ddof=1)                     # between-chain
    var_plus = (cn - 1) / cn * w + b / cn
    with np.errstate(divide="ignore", invalid="ignore"):
        r_hat = np.where(w > 0, np.sqrt(var_plus / w), np.inf)
        # constant-everywhere dims are trivially converged
        r_hat = np.where((w == 0) & (b == 0), 1.0, r_hat)

    # combined-chain autocovariance via FFT (biased 1/cn normalization)
    centered = sp - means[None]
    nfft = 1 << int(2 * cn - 1).bit_length()
    f = np.fft.rfft(centered, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:cn].real / cn
    mean_acov = acov.mean(axis=1)                          # (cn, d)
    safe_vp = np.where(var_plus > 0, var_plus, 1.0)
    rho = 1.0 - (w[None] - mean_acov) / safe_vp            # (cn, d)

    ess = np.empty(d)
    for j in range(d):
        if var_plus[j] == 0:
            ess[j] = cm * cn
            continue
        tau, t = 1.0, 1
        while t + 1 < cn:
            pair = rho[t, j] + rho[t + 1, j]
            if pair <= 0:
                break
            tau += 2.0 * pair
            t += 2
        ess[j] = cm * cn / max(tau, 1e-12)
    return {"r_hat": r_hat, "ess": ess}


# -- simulation-based calibration (SBC) -------------------------------------


def sbc_ranks(
    flow: Flow,
    theta_true,
    x_obs,
    *,
    n_draws: int = 256,
    key=None,
):
    """Simulation-based-calibration ranks for an amortized posterior flow.

    For each simulation i (θᵢ ~ prior, xᵢ ~ sim(θᵢ)), draws ``n_draws``
    posterior samples from q(θ | xᵢ) (one batched sampling program over
    all simulations at once) and ranks the TRUE θᵢ among them per
    parameter. If the posterior is calibrated the ranks are uniform on
    {0, …, n_draws} (Talts et al. 2018). Returns an (n_sims, d) integer
    array of ranks. Pair with :func:`sbc_uniformity` for a scalar
    diagnostic.
    """
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))
    theta_true = jnp.asarray(theta_true, jnp.float32)
    x_obs = np.asarray(x_obs, np.float32)
    n_sims = x_obs.shape[0]
    cond = np.broadcast_to(x_obs, (n_draws,) + x_obs.shape)
    draws = flow.sample((n_draws, n_sims), cond, key=key)
    return jnp.sum(draws < theta_true[None], axis=0)


def sbc_uniformity(ranks, n_draws: int):
    """Max-over-params Kolmogorov–Smirnov distance of the SBC ranks from
    uniform — 0 is perfectly calibrated; > ~1.6/√n_sims flags
    miscalibration at the 1% level."""
    ranks = np.asarray(ranks, np.float64)
    n_sims, d = ranks.shape
    u = (ranks + 0.5) / (n_draws + 1)
    grid = np.sort(u, axis=0)
    emp = np.arange(1, n_sims + 1)[:, None] / n_sims
    return float(np.max(np.abs(grid - emp)))
