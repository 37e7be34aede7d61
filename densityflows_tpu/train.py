"""NLL training: the whole training run as ONE fused XLA program.

JAX counterpart of the reference ``train!``
(/root/reference/src/Flows.jl:380-445). The reference's Python-visible
epoch/batch loop with per-batch ``Flux.gradient`` + ``Optimisers.update!``
becomes a single jitted program:

    lax.scan over epochs
      └─ on-device shuffle (jax.random.permutation)
      └─ lax.scan over batches: gather → inverse pass → NLL → grad →
         optax update (donated params/opt-state)
      └─ full-split train/valid eval               (src/Flows.jl:419-437)

One dispatch per ``train`` call: no host↔device traffic in the hot loop
(the dataset is uploaded once), no per-batch dispatch latency, and XLA
fuses the coupling-layer matmuls, the exp/affine elementwise chain, the
loss, and the Adam update into one schedule.

DataLoader semantics reproduced (``Flux.DataLoader(batchsize, shuffle)``,
src/Flows.jl:394): fresh shuffle each epoch, final partial batch kept —
implemented as padded gather indices + a loss mask so every batch keeps a
static shape.

Under a mesh, the data arrays are placed with
``NamedSharding(mesh, P('data'))``; the per-batch gather and the gradient
all-reduce (``psum`` over NVLink/NCCL) are inserted by the GSPMD partitioner.
Loss histories append on the host after the program returns, exactly as
the reference pushes into ``flow.train_loss`` / ``flow.valid_loss``.
"""

from __future__ import annotations

from functools import partial
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .data import DataArrays
from .models.flow import Flow

__all__ = [
    "train", "evaluate", "make_train_step", "make_train_program",
    "batch_iterator", "Adam", "adam",
]


class Adam:
    """``optax.adam`` with INTROSPECTABLE hyperparameters.

    ``optax.adam`` hides lr/b1/b2/eps inside its update closure, so
    ``train()`` could only key its compiled-program cache on the
    optimizer's identity, and ``train(flow, data, optax.adam(3e-4))``
    would recompile on every call. This drop-in (the same
    ``init``/``update`` GradientTransformation duck type, backed by a
    real ``optax.adam``) carries its hyperparameters, so two
    ``df.adam(3e-4)`` instances share one compiled program.
    """

    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = float(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        self._tx = optax.adam(self.learning_rate, b1=self.b1, b2=self.b2,
                              eps=self.eps)

    def init(self, params):
        return self._tx.init(params)

    def update(self, updates, state, params=None):
        return self._tx.update(updates, state, params)

    def __repr__(self):
        return (f"adam(learning_rate={self.learning_rate}, b1={self.b1}, "
                f"b2={self.b2}, eps={self.eps})")


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    """Adam with introspectable hyperparameters (see :class:`Adam`)."""
    return Adam(learning_rate, b1=b1, b2=b2, eps=eps)


def _adam_key(opt: Adam) -> tuple:
    """The tuple of hyperparameters that fully determines an Adam's
    update — the ONLY basis on which two Adam instances may share a
    cached program."""
    return ("df.adam", opt.learning_rate, opt.b1, opt.b2, opt.eps)


def _write_metrics(metrics_log, flow, epochs):
    """Append the last ``epochs`` history entries to the JSONL metrics
    log."""
    from .utils.logging import MetricsLogger

    logger = MetricsLogger(metrics_log)
    epoch0 = len(flow.train_loss) - epochs
    # slice from an explicit start: [-0:] would re-log the whole history
    for e, (tl, vl) in enumerate(zip(flow.train_loss[epoch0:],
                                     flow.valid_loss[epoch0:])):
        logger.write(epoch=epoch0 + e + 1, train_nll=float(tl),
                     valid_nll=float(vl))


def masked_nll_loss(model, base, x, theta, mask, *, remat: bool = False,
                    mixed_precision: bool = False):
    """NLL over valid rows only; ``mask`` zeroes padded rows so partial
    batches keep a static shape (loss semantics: src/Flows.jl:352-359).

    ``mask`` generalizes to per-row importance WEIGHTS: the loss is
    −Σ mᵢ·log p(xᵢ|θᵢ) / Σ mᵢ, so non-0/1 masks give the SNPE-B
    importance-weighted NLL (``inference.weighted_nll_loss``) and the
    all-ones mask reduces to the reference loss exactly.

    ``remat=True`` wraps each layer's inverse in ``jax.checkpoint`` so
    the backward pass recomputes activations per layer instead of
    storing the whole chain's — O(1) activation memory in chain depth,
    the standard FLOPs-for-HBM trade for deep chains / huge batches.

    ``mixed_precision=True`` casts conditioner-MLP weights to bf16
    *inside* the loss (master params stay f32, grads come back f32
    through the cast), so the conditioner matmuls run as native-bf16
    tensor-core passes with f32 accumulation while transform constants, s/t
    outputs, ldj, and the loss stay f32.
    """
    if mixed_precision:
        from .models.layers import cast_conditioners

        model = cast_conditioners(model, jnp.bfloat16)
    if remat:
        from .models.chains import FlowChain

        if isinstance(model, FlowChain):
            # per-layer remat: backward recomputes one layer at a time
            ldj = None
            y = x
            for layer in reversed(model.layers):
                y, ldj_i = jax.checkpoint(
                    lambda l, v, t: l.inverse(v, t)
                )(layer, y, theta)
                ldj = ldj_i if ldj is None else ldj + ldj_i
            z = y
        else:
            z, ldj = jax.checkpoint(
                lambda m, v, t: m.inverse(v, t)
            )(model, x, theta)
    else:
        z, ldj = model.inverse(x, theta)
    per_sample = base.log_prob(z) + ldj
    # epsilon (not 1.0) so the /Σw normalization holds even when importance
    # weights sum below 1 (SNPE-B ratios can be ≪ 1); the epsilon only
    # guards the all-padded batch, whose numerator is exactly 0
    denom = jnp.maximum(jnp.sum(mask), 1e-12)
    return -jnp.sum(per_sample * mask) / denom


def _eval_nll(model, base, x, theta):
    z, ldj = model.inverse(x, theta)
    return -jnp.mean(base.log_prob(z) + ldj)


# one jitted program shared by evaluate() and train_streaming — an eager
# full-split eval is op-by-op dispatch (~100 separate launches)
_eval_nll_jit = jax.jit(_eval_nll)


def make_train_step(optimizer, *, remat: bool = False,
                    mixed_precision: bool = False):
    """Single-batch fused step (loss + grad + update, donated state).

    The streaming alternative to :func:`make_train_program` for callers
    that feed batches from their own pipeline. ``remat=True`` enables
    per-layer rematerialization; ``mixed_precision=True`` runs the
    conditioner matmuls in bf16 with f32 master params/grads/optimizer
    state (see :func:`masked_nll_loss`).
    """

    @partial(jax.jit, donate_argnums=(0, 1))
    def train_step(model, opt_state, base, x, theta, mask):
        loss, grads = jax.value_and_grad(
            partial(masked_nll_loss, remat=remat,
                    mixed_precision=mixed_precision)
        )(model, base, x, theta, mask)
        updates, opt_state = optimizer.update(grads, opt_state, model)
        model = optax.apply_updates(model, updates)
        return model, opt_state, loss

    return train_step


_PROGRAM_CACHE: dict = {}

_DEFAULT_ADAM = None


def _default_adam():
    """One shared Adam(1e-3) instance (the reference's de-facto default,
    test/runtests.jl:114). Sharing the instance keeps the fused-program
    cache warm across ``train`` calls — the cache keys on
    ``id(optimizer)``."""
    global _DEFAULT_ADAM
    if _DEFAULT_ADAM is None:
        _DEFAULT_ADAM = optax.adam(1e-3)
    return _DEFAULT_ADAM


def _row_mask(n_rows_padded: int, n_valid: int):
    row = jax.lax.broadcasted_iota(jnp.int32, (n_rows_padded, 1), 0)[:, 0]
    return (row < n_valid).astype(jnp.float32)


def _tree_select(pred, a, b):
    """Per-leaf ``jnp.where(pred, a, b)`` over matching pytrees."""
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


def _all_finite(loss, grads):
    ok = jnp.isfinite(loss)
    for leaf in jax.tree_util.tree_leaves(grads):
        ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(leaf)))
    return ok


def make_train_program(
    optimizer,
    batchsize: int,
    epochs: int,
    shuffle: bool = True,
    n_train: int | None = None,
    n_valid: int | None = None,
    batch_sharding=None,
    pure: bool = False,
    remat: bool = False,
    mixed_precision: bool = False,
    weighted: bool = False,
    track_best: bool = False,
    guard_nonfinite: bool = False,
):
    """Build (and cache) the fused multi-epoch training program.

    ``n_train``/``n_valid`` are the REAL row counts; the x/theta arrays may
    be zero-padded beyond them (for even mesh placement) — padded rows are
    masked out of every loss. ``batch_sharding`` (a NamedSharding), when
    given, constrains each gathered batch so the GSPMD partitioner keeps
    the batch distributed and inserts the gradient psum.

    Returns ``fn(model, opt_state, base, x, theta, x_valid, theta_valid,
    key) -> (model, opt_state, train_losses, valid_losses)`` where the
    losses are per-epoch full-split NLLs (reference epoch bookkeeping,
    src/Flows.jl:419-437). Opt-in extensions:

    - ``weighted=True``: the program takes per-row importance weights —
      ``fn(model, opt_state, base, x, theta, w, x_valid, theta_valid,
      w_valid, key)`` — and every batch loss AND both full-split epoch
      evals become the SNPE-B weighted NLL (−Σwᵢ·log pᵢ / Σwᵢ). Uniform
      weights reproduce the unweighted program bit-for-bit.
    - ``track_best=True``: appends ``best_model`` to the outputs — the
      exact parameter pytree at the epoch with the lowest validation NLL,
      carried through the epoch scan with a per-leaf ``jnp.where`` select
      (exact best-epoch restore, independent of host chunking).
    - ``guard_nonfinite=True``: appends ``skips`` (per-epoch int32 counts)
      — each batch update is applied only if the loss and every gradient
      leaf are finite; non-finite steps leave params/optimizer state
      untouched and are counted (fused-program analogue of the
      reference's per-batch debug hooks, src/Flows.jl:405-409).
    """
    # tagged Adams key by hyperparameters (the documented usage
    # `train(flow, data, df.adam(3e-3))` creates a fresh instance per
    # call — an id() key would recompile every time on the jnp path);
    # opaque optimizers — including Adam SUBCLASSES, whose update() may
    # differ — key by identity
    if type(optimizer) is Adam:
        opt_key = _adam_key(optimizer)
    else:
        opt_key = id(optimizer)
    cache_key = (opt_key, batchsize, epochs, shuffle, n_train, n_valid,
                 batch_sharding, pure, remat, mixed_precision, weighted,
                 track_best, guard_nonfinite)
    cached = _PROGRAM_CACHE.get(cache_key)
    # the entry stores the optimizer itself: it keeps the id() alive (a
    # GC'd optimizer could hand its id to a NEW optimizer and silently
    # hit a stale program) and the identity/equivalence check makes
    # collisions impossible rather than merely unlikely
    # two Adams are interchangeable only if their tagged hyperparameters
    # agree — compared explicitly (not via cache_key alone) so adding a
    # field to Adam without extending _adam_key fails loudly in tests
    # rather than silently sharing a program
    if cached is not None and (
            cached[0] is optimizer
            or (type(optimizer) is Adam and type(cached[0]) is Adam
                and _adam_key(optimizer) == _adam_key(cached[0]))):
        return cached[1]
    # epoch bookkeeping evals stay f32 even under mixed precision: loss
    # histories are the correctness record (src/Flows.jl:419-437)
    loss_fn = partial(masked_nll_loss, remat=remat,
                      mixed_precision=mixed_precision)

    def body(model, opt_state, base, x, theta, w, x_valid, theta_valid,
             w_valid, key):
        n = x.shape[0] if n_train is None else n_train
        nv = x_valid.shape[0] if n_valid is None else n_valid
        n_batches = -(-n // batchsize)
        n_pad = n_batches * batchsize
        pad_mask = _row_mask(n_pad, n).reshape(n_batches, batchsize)
        train_row_mask = _row_mask(x.shape[0], n)
        valid_row_mask = _row_mask(x_valid.shape[0], nv)
        if weighted:
            train_row_mask = train_row_mask * w
            valid_row_mask = valid_row_mask * w_valid

        def constrain(a):
            if batch_sharding is not None:
                return jax.lax.with_sharding_constraint(a, batch_sharding)
            return a

        def epoch_body(carry, ekey):
            model, opt_state, best_vl, best_model = carry
            if shuffle:
                perm = jax.random.permutation(ekey, n).astype(jnp.int32)
            else:
                perm = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
            idx = jnp.zeros((n_pad,), jnp.int32).at[:n].set(perm)
            idx = idx.reshape(n_batches, batchsize)

            def batch_body(carry, im):
                model, opt_state = carry
                i, m = im
                if weighted:
                    m = m * w[i]
                loss, grads = jax.value_and_grad(loss_fn)(
                    model, base, constrain(x[i]), constrain(theta[i]), m
                )
                if guard_nonfinite:
                    ok = _all_finite(loss, grads)
                    updates, new_opt = optimizer.update(grads, opt_state, model)
                    new_model = optax.apply_updates(model, updates)
                    model = _tree_select(ok, new_model, model)
                    opt_state = _tree_select(ok, new_opt, opt_state)
                    skip = 1 - ok.astype(jnp.int32)
                else:
                    updates, opt_state = optimizer.update(grads, opt_state, model)
                    model = optax.apply_updates(model, updates)
                    skip = jnp.int32(0)
                return (model, opt_state), skip

            (model, opt_state), skips = jax.lax.scan(
                batch_body, (model, opt_state), (idx, pad_mask)
            )
            tl = masked_nll_loss(model, base, x, theta, train_row_mask)
            vl = masked_nll_loss(model, base, x_valid, theta_valid, valid_row_mask)
            if track_best:
                better = vl < best_vl
                best_vl = jnp.where(better, vl, best_vl)
                best_model = _tree_select(better, model, best_model)
            return (model, opt_state, best_vl, best_model), (tl, vl, jnp.sum(skips))

        keys = jax.random.split(key, epochs)
        best0 = jax.tree_util.tree_map(jnp.asarray, model) if track_best else 0
        (model, opt_state, _, best_model), (tls, vls, skips) = jax.lax.scan(
            epoch_body, (model, opt_state, jnp.float32(jnp.inf), best0), keys
        )
        out = [model, opt_state, tls, vls]
        if track_best:
            out.append(best_model)
        if guard_nonfinite:
            out.append(skips)
        return tuple(out)

    if weighted:
        def train_program_pure(model, opt_state, base, x, theta, w,
                               x_valid, theta_valid, w_valid, key):
            return body(model, opt_state, base, x, theta, w,
                        x_valid, theta_valid, w_valid, key)
    else:
        def train_program_pure(model, opt_state, base, x, theta,
                               x_valid, theta_valid, key):
            return body(model, opt_state, base, x, theta, None,
                        x_valid, theta_valid, None, key)

    if pure:
        # unjitted body, for callers that wrap the program in their own
        # transform (e.g. ensemble.py vmaps it over a member axis)
        train_program = train_program_pure
    else:
        train_program = jax.jit(train_program_pure, donate_argnums=(0, 1))
    _PROGRAM_CACHE[cache_key] = (optimizer, train_program)
    return train_program



def _train_with_checkpoints(
    flow, data, optimizer, opt_state, *, epochs, batchsize, shuffle,
    verbose, key, mesh, debug, checkpoint_dir, checkpoint_every, resume,
    metrics_log=None, remat=False, mixed_precision=False,
    weights=None, skip_nonfinite=False,
):
    """Chunked fused-program training with checkpoint-restart recovery.

    Every chunk is the SAME ``checkpoint_every``-epoch fused program
    (one jit cache entry), so chunking costs one host roundtrip + one
    checkpoint write per chunk, not a recompile.
    """
    import os

    from .utils.checkpoint import save_flow, load_flow

    if optimizer is None:
        optimizer = _default_adam()
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))

    done = 0
    if resume and os.path.exists(os.path.join(checkpoint_dir, "flow.json")):
        restored = load_flow(checkpoint_dir, optimizer)
        if isinstance(restored, tuple):
            restored_flow, opt_state = restored
        else:
            restored_flow, opt_state = restored, None
        flow.model = restored_flow.model
        flow.train_loss[:] = restored_flow.train_loss
        flow.valid_loss[:] = restored_flow.valid_loss
        done = len(flow.train_loss)
        if verbose and done:
            print(f"[resumed from {checkpoint_dir} at epoch {done}]")

    target = max(epochs, done)
    # per-chunk keys derived from position so a resumed run replays the
    # exact shuffle sequence of an uninterrupted one
    while done < target:
        chunk = min(checkpoint_every, target - done)
        chunk_key = jax.random.fold_in(key, done)
        opt_state = train(
            flow, data, optimizer, opt_state,
            epochs=chunk, batchsize=batchsize, shuffle=shuffle,
            verbose=verbose, key=chunk_key, mesh=mesh, debug=debug,
            metrics_log=metrics_log, remat=remat,
            mixed_precision=mixed_precision,
            weights=weights, skip_nonfinite=skip_nonfinite,
        )
        done += chunk
        save_flow(checkpoint_dir, flow, opt_state, erase=True)
    return opt_state


def _train_early_stopping(
    flow, data, optimizer, opt_state, *, epochs, batchsize, shuffle,
    verbose, key, mesh, debug, patience, min_delta, check_every,
    restore_best, metrics_log, remat=False, mixed_precision=False,
    weights=None, skip_nonfinite=False,
):
    """Chunked fused-program training with validation-based early stopping.

    Every chunk is the same ``check_every``-epoch fused program (one jit
    cache entry); between chunks the host inspects the validation-loss
    tail. Stops once the best valid NLL hasn't improved by ``min_delta``
    for ``patience`` consecutive epochs; with ``restore_best`` the model
    is rolled back to the EXACT best-epoch parameters — each chunk's
    program carries (best_valid, best_params) through its epoch scan
    (``track_best``), so the restore is epoch-exact regardless of
    ``check_every``.
    """
    if key is None:
        key = jax.random.key(np.random.randint(0, 2**31 - 1))

    best = float("inf")
    best_restore = float("inf")
    best_model = None
    best_epoch = 0
    done = 0
    while done < epochs:
        chunk = min(check_every, epochs - done)
        chunk_key = jax.random.fold_in(key, done)
        res = train(
            flow, data, optimizer, opt_state,
            epochs=chunk, batchsize=batchsize, shuffle=shuffle,
            verbose=verbose, key=chunk_key, mesh=mesh, debug=debug,
            metrics_log=metrics_log, remat=remat,
            mixed_precision=mixed_precision,
            weights=weights, skip_nonfinite=skip_nonfinite,
            _track_best=restore_best,
        )
        opt_state, chunk_best = res if restore_best else (res, None)
        done += chunk
        tail = flow.valid_loss[-chunk:]
        if restore_best and min(tail) < best_restore:
            # chunk_best is the exact argmin-epoch pytree from the scan
            best_restore = min(tail)
            best_model = chunk_best
        if min(tail) < best - min_delta:
            i_rel = int(np.argmin(tail))
            best = tail[i_rel]
            best_epoch = done - chunk + i_rel + 1
        no_improve_for = done - best_epoch
        if no_improve_for >= patience:
            if verbose:
                print(
                    f"[early stop at epoch {done}: no valid improvement "
                    f"> {min_delta} for {no_improve_for} epochs; best "
                    f"{best:.6f} @ epoch {best_epoch}]"
                )
            break
    if restore_best and best_model is not None:
        flow.model = best_model
    return opt_state


def evaluate(flow: Flow, data: DataArrays, split: str = "testing") -> float:
    """Full-split NLL on ``'training'``/``'validation'``/``'testing'``.

    The held-out evaluation entry point the reference computes inline per
    epoch (src/Flows.jl:419-437) but never exposes for the test split.
    """
    getter = {
        "training": data.normalized_training_data,
        "validation": data.normalized_validation_data,
    }.get(split)
    if getter is not None:
        x, th = getter(flow.metadata)
    elif split == "testing":
        x, th = data.testing_data()
        from .data import normalize_input

        th = normalize_input(th, flow.metadata.theta_min, flow.metadata.theta_max)
    else:
        raise ValueError(f"unknown split {split!r}")
    if x.shape[0] == 0:
        raise ValueError(f"split {split!r} is empty")
    return float(
        _eval_nll_jit(flow.model, flow.base, jnp.asarray(x), jnp.asarray(th))
    )


def batch_iterator(
    x: np.ndarray,
    theta: np.ndarray,
    batchsize: int,
    *,
    shuffle: bool = True,
    rng: np.random.Generator | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Host-side batcher for the streaming path: yields
    (x_batch, theta_batch, mask) with static shapes (``Flux.DataLoader``
    semantics, src/Flows.jl:394)."""
    n = x.shape[0]
    if rng is None:
        rng = np.random.default_rng()
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batchsize):
        idx = order[start : start + batchsize]
        k = len(idx)
        mask = np.zeros((batchsize,), np.float32)
        mask[:k] = 1.0
        if k < batchsize:
            idx = np.concatenate([idx, np.zeros((batchsize - k,), idx.dtype)])
        yield x[idx], theta[idx], mask


_DEBUG_CHUNK = 10


def train(
    flow: Flow,
    data: DataArrays,
    optimizer=None,
    opt_state=None,
    *,
    epochs: int = 100,
    batchsize: int = 64,
    shuffle: bool = True,
    verbose: bool = True,
    key=None,
    mesh=None,
    debug: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    metrics_log: str | None = None,
    early_stopping_patience: int | None = None,
    early_stopping_min_delta: float = 0.0,
    early_stopping_check_every: int | None = None,
    restore_best: bool = True,
    remat: bool = False,
    mixed_precision: bool = False,
    weights=None,
    skip_nonfinite: bool = False,
    _track_best: bool = False,
):
    """Train the flow by NLL (reference ``train!``, src/Flows.jl:380-445).

    Defaults match the reference: epochs=100, batchsize=64, shuffle=True,
    and the de-facto Adam(1e-3) from the reference docs/tests
    (test/runtests.jl:114). θ is normalized once via the flow's metadata
    (src/Flows.jl:391-392). Runs as one fused on-device program.

    Fault tolerance (no reference counterpart, SURVEY.md §5): with
    ``checkpoint_dir`` set, the run is chunked into fused programs of
    ``checkpoint_every`` epochs with a full checkpoint (model + optimizer
    state + histories) written between chunks; ``resume=True`` restarts
    from the last checkpoint, skipping already-completed epochs.

    ``remat=True`` rematerializes per-layer activations in the backward
    pass (``jax.checkpoint``) — O(1) activation memory in chain depth,
    for deep chains or batches that would otherwise exhaust HBM.

    ``mixed_precision=True`` runs the conditioner-MLP matmuls in bf16
    (bf16 tensor-core passes, f32 accumulation) while master params,
    grads, optimizer state, per-epoch loss evals, s/t/ldj, and the loss
    all stay f32.

    Early stopping (no reference counterpart): set
    ``early_stopping_patience=p`` to stop once the validation NLL hasn't
    improved by ``early_stopping_min_delta`` for ``p`` epochs (checked
    every ``early_stopping_check_every`` epochs, default ``min(p, 10)``);
    ``restore_best`` rolls the model back to the exact best-validation
    EPOCH's parameters (carried through the epoch scan on device).

    ``weights`` (optional): per-row importance weights aligned with the
    RAW ``data`` rows — batch losses and both per-epoch full-split evals
    become the weighted NLL −Σwᵢ·log pᵢ / Σwᵢ (SNPE-B correction; the
    uniform-weights case is bit-identical to the unweighted program).

    ``skip_nonfinite=True``: each batch update is applied only when the
    loss and all gradients are finite; non-finite steps leave the state
    untouched and are counted in ``flow.skipped_updates`` (one entry per
    epoch) — the in-program analogue of the reference's per-batch debug
    hooks (src/Flows.jl:405-409). ``debug=True`` additionally chunks the
    run into 10-epoch fused programs so a non-finite epoch loss raises
    within ~10 epochs instead of after the whole run.

    Returns ``opt_state`` so training can be continued exactly (the
    reference loses optimizer state across save/load; we keep it).
    """
    if early_stopping_patience is not None:
        if checkpoint_dir is not None:
            raise ValueError(
                "early stopping and checkpoint_dir are separate chunked "
                "drivers — use one or the other"
            )
        return _train_early_stopping(
            flow, data, optimizer, opt_state,
            epochs=epochs, batchsize=batchsize, shuffle=shuffle,
            verbose=verbose, key=key, mesh=mesh, debug=debug,
            patience=early_stopping_patience,
            min_delta=early_stopping_min_delta,
            check_every=(early_stopping_check_every
                         or min(early_stopping_patience, 10)),
            restore_best=restore_best, metrics_log=metrics_log,
            remat=remat, mixed_precision=mixed_precision,
            weights=weights, skip_nonfinite=skip_nonfinite,
        )
    if checkpoint_dir is not None:
        return _train_with_checkpoints(
            flow, data, optimizer, opt_state,
            epochs=epochs, batchsize=batchsize, shuffle=shuffle,
            verbose=verbose, key=key, mesh=mesh, debug=debug,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            metrics_log=metrics_log,
            remat=remat, mixed_precision=mixed_precision,
            weights=weights, skip_nonfinite=skip_nonfinite,
        )
    if optimizer is None:
        optimizer = _default_adam()
    if key is None:
        seed = np.random.randint(0, 2**31 - 1)
        if mesh is not None and jax.process_count() > 1:
            # every process must run the program with the SAME key (the
            # on-device shuffle is part of the SPMD program) — broadcast
            # process 0's seed
            from jax.experimental import multihost_utils

            seed = int(multihost_utils.broadcast_one_to_all(np.int32(seed)))
        key = jax.random.key(seed)

    if debug and epochs > _DEBUG_CHUNK and not _track_best:
        # chunked execution so a non-finite epoch loss raises within
        # ~_DEBUG_CHUNK epochs, not after the whole fused run (reference
        # per-batch debug hooks, src/Flows.jl:405-409)
        done = 0
        while done < epochs:
            chunk = min(_DEBUG_CHUNK, epochs - done)
            opt_state = train(
                flow, data, optimizer, opt_state,
                epochs=chunk, batchsize=batchsize, shuffle=shuffle,
                verbose=verbose, key=jax.random.fold_in(key, done),
                mesh=mesh, debug=True, metrics_log=metrics_log,
                remat=remat, mixed_precision=mixed_precision,
                weights=weights, skip_nonfinite=skip_nonfinite,
            )
            done += chunk
        return opt_state

    x_train, th_train = data.normalized_training_data(flow.metadata)
    x_valid, th_valid = data.normalized_validation_data(flow.metadata)
    n_train, n_valid = x_train.shape[0], x_valid.shape[0]

    w_train = w_valid = None
    if weights is not None:
        w = np.asarray(weights, np.float32).reshape(-1)
        if w.shape[0] != data.x.shape[0]:
            raise ValueError(
                f"weights must have one entry per data row "
                f"({data.x.shape[0]}), got {w.shape[0]}"
            )
        w_train = w[np.asarray(data.partition.training)]
        w_valid = w[np.asarray(data.partition.validation)]

    batch_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh_n = mesh.shape["data"]
        batch_sharding = NamedSharding(mesh, P("data", None))

        def pad_rows(arr):
            pad = (-arr.shape[0]) % mesh_n
            if pad:
                arr = np.concatenate(
                    [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)]
                )
            return arr

        x_train, th_train = pad_rows(x_train), pad_rows(th_train)
        x_valid, th_valid = pad_rows(x_valid), pad_rows(th_valid)
        if weights is not None:
            w_train, w_valid = pad_rows(w_train), pad_rows(w_valid)

    def put(arr):
        arr = np.ascontiguousarray(arr)
        if batch_sharding is None:
            return jnp.asarray(arr)
        # multi-process safe: each host contributes its row slice and jax
        # assembles the global sharded array (SURVEY.md §2.2 DP disposition)
        from .parallel.mesh import put_global

        return put_global(mesh, arr)

    xt, tht, xv, thv = put(x_train), put(th_train), put(x_valid), put(th_valid)

    model = flow.model

    if opt_state is None:
        opt_state = optimizer.init(model)
    if mesh is not None and jax.process_count() > 1:
        # params/optimizer state are replicated; on a multi-process mesh
        # they must be explicit global arrays (every process holds the
        # same host value by deterministic construction)
        from .parallel.mesh import put_replicated

        model = put_replicated(mesh, model)
        opt_state = put_replicated(mesh, opt_state)

    program = make_train_program(
        optimizer, batchsize, epochs, shuffle,
        n_train=n_train, n_valid=n_valid, batch_sharding=batch_sharding,
        remat=remat, mixed_precision=mixed_precision,
        weighted=weights is not None, track_best=_track_best,
        guard_nonfinite=skip_nonfinite,
    )
    import time as _time

    t0 = _time.perf_counter()
    if weights is not None:
        out = program(
            model, opt_state, flow.base, xt, tht, put(w_train),
            xv, thv, put(w_valid), key,
        )
    else:
        out = program(model, opt_state, flow.base, xt, tht, xv, thv, key)
    model, opt_state, tls, vls = out[:4]
    rest = list(out[4:])
    best_model = rest.pop(0) if _track_best else None
    skips = np.asarray(rest.pop(0)) if skip_nonfinite else None
    tls = np.asarray(tls)  # host fetch blocks on program completion
    vls = np.asarray(vls)
    elapsed = _time.perf_counter() - t0
    flow.model = model
    flow.train_loss.extend(float(v) for v in tls)
    flow.valid_loss.extend(float(v) for v in vls)
    if skips is not None:
        flow.skipped_updates.extend(int(v) for v in skips)
        if verbose and skips.sum():
            print(f"[skipped {int(skips.sum())} non-finite updates]")

    if metrics_log is not None:
        _write_metrics(metrics_log, flow, epochs)

    if debug and (not np.all(np.isfinite(tls)) or not np.all(np.isfinite(vls))):
        raise FloatingPointError(
            "non-finite epoch loss encountered "
            f"(train={tls.tolist()}, valid={vls.tolist()}) — "
            "reference debug hook analogue, src/Flows.jl:405-409"
        )
    if verbose:
        for e, (tl, vl) in enumerate(zip(tls, vls)):
            print(
                f"epoch: {len(flow.train_loss) - epochs + e + 1} | "
                f"train_loss = {tl}, valid_loss = {vl}"
            )
        sps = epochs * n_train / elapsed if elapsed > 0 else float("inf")
        n_chips = max(1, jax.local_device_count())
        print(
            f"[{elapsed:.2f}s incl. compile | {sps:,.0f} samples/s "
            f"| {sps / n_chips:,.0f} samples/s/chip]"
        )
    if _track_best:
        return opt_state, best_model
    return opt_state
