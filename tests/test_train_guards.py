"""Tests for train()'s weighted path, non-finite guarding, debug chunking,
and exact best-epoch restore (VERDICT round-1 items 3, 4, 6)."""

import numpy as np
import jax
import optax
import pytest

import densityflows_tpu as df


def _setup(seed=0, n=400):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3)) * np.array([1.0, 0.5, 2.0])).astype(np.float32)
    data = df.DataArrays.make(x, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1], key=jax.random.key(0)),
        df.coupling_layer(data, [1, 2], key=jax.random.key(1)),
        df.normalization_layer(x, -1.0, 1.0),
    )
    return df.Flow(chain, data), data


# -- weighted fused path ------------------------------------------------------


def test_uniform_weights_bit_identical_to_unweighted():
    # multiplying the loss mask by w=1.0 is exact in float — the weighted
    # program must reproduce the unweighted one bit for bit
    opt = optax.adam(1e-3)
    flow_a, data = _setup()
    flow_b, _ = _setup()
    k = jax.random.key(7)
    df.train(flow_a, data, opt, epochs=3, verbose=False, key=k)
    df.train(flow_b, data, opt, epochs=3, verbose=False, key=k,
             weights=np.ones(data.x.shape[0], np.float32))
    assert flow_a.train_loss == flow_b.train_loss
    assert flow_a.valid_loss == flow_b.valid_loss
    for la, lb in zip(jax.tree_util.tree_leaves(flow_a.model),
                      jax.tree_util.tree_leaves(flow_b.model)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_weighted_training_downweights_rows():
    # two clusters; weighting one cluster to ~0 must fit the other only
    rng = np.random.default_rng(3)
    xa = rng.normal(loc=0.0, scale=0.3, size=(300, 2))
    xb = rng.normal(loc=6.0, scale=0.3, size=(300, 2))
    x = np.concatenate([xa, xb]).astype(np.float32)
    w = np.concatenate([np.ones(300), np.full(300, 1e-6)]).astype(np.float32)
    data = df.DataArrays.make(x, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0], key=jax.random.key(0)),
        df.coupling_layer(data, [1], key=jax.random.key(1)),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    df.train(flow, data, epochs=60, verbose=False, key=jax.random.key(2),
             weights=w)
    lp_a = float(np.mean(np.asarray(flow.log_prob(xa.astype(np.float32)))))
    lp_b = float(np.mean(np.asarray(flow.log_prob(xb.astype(np.float32)))))
    assert lp_a > lp_b + 2.0


def test_weights_length_mismatch_raises():
    flow, data = _setup()
    with pytest.raises(ValueError):
        df.train(flow, data, epochs=1, verbose=False,
                 weights=np.ones(7, np.float32))


def test_fit_posterior_weighted_uses_fused_histories():
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(256, 1)).astype(np.float32)
    x = (theta + 0.1 * rng.normal(size=(256, 1))).astype(np.float32)
    data = df.DataArrays.make(theta, x, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0], key=jax.random.key(0)),
        df.normalization_layer(theta, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    w = rng.uniform(0.5, 2.0, size=256).astype(np.float32)
    df.fit_posterior(flow, theta, x, weights=w, epochs=3,
                     key=jax.random.key(1))
    # fused path: full-split per-epoch histories for BOTH splits
    assert len(flow.train_loss) == 3
    assert len(flow.valid_loss) == 3
    assert np.all(np.isfinite(flow.train_loss))


# -- non-finite guarding ------------------------------------------------------


def test_skip_nonfinite_survives_exploding_lr():
    flow, data = _setup(1)
    # an absurd LR explodes exp(s) within a few updates → NaN loss/grads
    opt = optax.sgd(1e6)
    df.train(flow, data, opt, epochs=5, verbose=False, key=jax.random.key(0),
             skip_nonfinite=True)
    assert len(flow.skipped_updates) == 5
    assert sum(flow.skipped_updates) > 0
    for leaf in jax.tree_util.tree_leaves(flow.model):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_skip_nonfinite_noop_on_healthy_run():
    opt = optax.adam(1e-3)
    flow_a, data = _setup(2)
    flow_b, _ = _setup(2)
    k = jax.random.key(5)
    df.train(flow_a, data, opt, epochs=3, verbose=False, key=k)
    df.train(flow_b, data, opt, epochs=3, verbose=False, key=k,
             skip_nonfinite=True)
    assert sum(flow_b.skipped_updates) == 0
    assert flow_a.train_loss == flow_b.train_loss


def test_debug_chunks_raise_early():
    flow, data = _setup(3)
    opt = optax.sgd(1e6)
    with pytest.raises(FloatingPointError):
        df.train(flow, data, opt, epochs=100, verbose=False,
                 key=jax.random.key(0), debug=True)
    # chunked execution: the failure surfaced within the first chunk(s),
    # not after all 100 epochs
    assert len(flow.train_loss) <= 20


# -- exact best-epoch restore -------------------------------------------------


def test_early_stopping_restores_exact_best_epoch():
    # small training set + long budget → overfits; the restored model's
    # valid NLL must EQUAL the recorded minimum (same params, same eval)
    flow, data = _setup(4, n=120)
    df.train(
        flow, data, epochs=300, verbose=False, key=jax.random.key(6),
        early_stopping_patience=30, early_stopping_check_every=7,
        early_stopping_min_delta=0.0,
    )
    vl = df.evaluate(flow, data, "validation")
    best = min(flow.validation_loss)
    assert abs(vl - best) < 1e-5, (vl, best)


# -- tagged Adam through the chunked drivers ----------------------------------


def test_tagged_adam_through_chunked_drivers(tmp_path):
    """df.adam(...) flows through the early-stopping and
    checkpoint-restart chunk drivers (each chunk is a plain-surface
    train() call running the jnp program with the cached-by-
    hyperparameters Adam)."""
    flow, data = _setup(7)
    df.train(flow, data, df.adam(2e-3), epochs=12, batchsize=32,
             verbose=False, key=jax.random.key(1),
             early_stopping_patience=6, early_stopping_check_every=4)
    assert len(flow.train_loss) >= 4
    assert np.isfinite(flow.train_loss).all()

    flow2, _ = _setup(7)
    s = df.train(flow2, data, df.adam(2e-3), epochs=6, batchsize=32,
                 verbose=False, key=jax.random.key(2),
                 checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert len(flow2.train_loss) == 6
    # resume is a no-op when the checkpoint is already at target
    df.train(flow2, data, df.adam(2e-3), s, epochs=6, batchsize=32,
             verbose=False, key=jax.random.key(2),
             checkpoint_dir=str(tmp_path), resume=True)
    assert len(flow2.train_loss) == 6


# -- optimizer program-cache equivalence (ADVICE r4) --------------------------


def test_adam_subclass_does_not_share_cached_program():
    """An Adam SUBCLASS may override update() with different semantics:
    it must key the program cache by identity (not hyperparameters) and
    never be treated as kernel-routable (ADVICE r4, train.py cache-hit
    check)."""
    from densityflows_tpu.train import make_train_program

    class SignAdam(df.Adam):
        def update(self, updates, state, params=None):
            u, s = super().update(updates, state, params)
            u = jax.tree_util.tree_map(jax.numpy.sign, u)
            return u, s

    base = df.adam(1e-3)
    sub = SignAdam(1e-3)
    prog_base = make_train_program(base, batchsize=32, epochs=2)
    prog_sub = make_train_program(sub, batchsize=32, epochs=2)
    assert prog_base is not prog_sub
    # identical tagged hyperparameters on the exact type DO share
    assert make_train_program(df.adam(1e-3), batchsize=32, epochs=2) is prog_base
    # different hyperparameters do not
    assert make_train_program(df.adam(2e-3), batchsize=32, epochs=2) is not prog_base
    # and the subclass keys by identity: a fresh instance recompiles
    assert make_train_program(SignAdam(1e-3), batchsize=32, epochs=2) is not prog_sub


def test_adam_subclass_trains_with_its_own_update():
    # end-to-end: the overridden update actually runs (sign-clipped steps
    # move every parameter by exactly ±lr when moments are fresh)
    class ZeroAdam(df.Adam):
        def update(self, updates, state, params=None):
            u, s = super().update(updates, state, params)
            u = jax.tree_util.tree_map(jax.numpy.zeros_like, u)
            return u, s

    flow, data = _setup(11)
    # snapshot to host first: the train program donates the model buffers
    before = [np.asarray(l).copy()
              for l in jax.tree_util.tree_leaves(flow.model)]
    df.train(flow, data, ZeroAdam(1e-3), epochs=2, verbose=False,
             key=jax.random.key(0))
    after = jax.tree_util.tree_leaves(flow.model)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, np.asarray(b))
