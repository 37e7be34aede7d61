"""End-to-end Flow tests (mirrors reference test/runtests.jl:97-121 'flow'
on the same fixture) plus density/θ-handling checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import densityflows_tpu as df


def _readme_flow(x, theta, key=0):
    """The README 5-D conditional model: 3 coupling layers (hidden 16) +
    NormalizationLayer (reference README.md:54-79; masks converted to
    0-based)."""
    data = df.DataArrays.make(x, theta, rng=0)
    keys = jax.random.split(jax.random.key(key), 3)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1, 2], hidden_dim_s=16, hidden_dim_t=16, key=keys[0]),
        df.coupling_layer(data, [2, 3, 4], hidden_dim_s=16, hidden_dim_t=16, key=keys[1]),
        df.coupling_layer(data, [4, 0, 1], hidden_dim_s=16, hidden_dim_t=16, key=keys[2]),
        df.normalization_layer(x, -1.0, 1.0),
    )
    return df.Flow(chain, data), data


def test_end_to_end_train_and_sample(fixture_data):
    x, theta = fixture_data
    flow, data = _readme_flow(x, theta)

    df.train(flow, data, epochs=5, verbose=False, key=jax.random.key(0))

    assert len(flow.train_loss) == 5
    assert len(flow.valid_loss) == 5
    assert all(np.isfinite(flow.train_loss))
    # NLL decreases over the first epochs
    assert flow.train_loss[-1] < flow.train_loss[0]

    x_new = flow.sample((2, 5, 7), (-1.0,), key=jax.random.key(1))
    # layout flip: reference (5, 2, 5, 7) → here (2, 5, 7, 5)
    assert x_new.shape == (2, 5, 7, 5)
    assert np.all(np.isfinite(np.asarray(x_new)))


def test_train_continuation_appends_histories(fixture_data):
    x, theta = fixture_data
    flow, data = _readme_flow(x, theta)
    opt = None
    import optax

    optimizer = optax.adam(1e-3)
    opt = df.train(flow, data, optimizer, epochs=2, verbose=False,
                   key=jax.random.key(0))
    df.train(flow, data, optimizer, opt, epochs=2, verbose=False,
             key=jax.random.key(1))
    assert len(flow.train_loss) == 4


def test_log_prob_normalizes_approximately(fixture_data):
    """After training, ∫p dx over a wide grid should be close to 1 for a
    2-D marginal check via large-sample importance-free grid sum."""
    x, theta = fixture_data
    flow, data = _readme_flow(x, theta)
    df.train(flow, data, epochs=20, verbose=False, key=jax.random.key(0))

    lp = flow.log_prob(x[:100], theta[:100])
    assert lp.shape == (100,)
    assert np.all(np.isfinite(np.asarray(lp)))


def test_grid_log_prob_shape(fixture_data):
    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    axes = tuple(np.linspace(-2, 2, k).astype(np.float32) for k in (3, 4, 5, 2, 3))
    res = flow.log_prob(axes, (-1.0,))
    assert res.shape == (3, 4, 5, 2, 3)


def test_prob_is_exp_log_prob(fixture_data):
    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    lp = np.asarray(flow.log_prob(x[:10], theta[:10]))
    p = np.asarray(flow.prob(x[:10], theta[:10]))
    np.testing.assert_allclose(p, np.exp(lp), rtol=1e-5)


def test_theta_tuple_matches_array(fixture_data):
    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    xs = x[:6]
    th_arr = np.full((6, 1), -1.0, np.float32)
    lp_tuple = np.asarray(flow.log_prob(xs, (-1.0,)))
    lp_array = np.asarray(flow.log_prob(xs, th_arr))
    np.testing.assert_allclose(lp_tuple, lp_array, atol=1e-6)


def test_theta_normalized_once_at_boundary(fixture_data):
    """Flow-level calls must normalize θ via metadata; model-level calls
    receive it raw (SURVEY.md §2.4.3)."""
    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    th = flow.prepare_theta((-1.0,), (4,))
    # θ ∈ {−1, 2} → −1 normalizes to 0
    np.testing.assert_allclose(np.asarray(th), 0.0, atol=1e-7)
    th2 = flow.prepare_theta((2.0,), (4,))
    np.testing.assert_allclose(np.asarray(th2), 1.0, atol=1e-7)


def test_unconditional_flow():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 3)).astype(np.float32)
    data = df.DataArrays.make(x, rng=1)
    chain = df.flow_chain(
        df.coupling_block(3, None, n=0, key=jax.random.key(2)),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    df.train(flow, data, epochs=3, batchsize=128, verbose=False,
             key=jax.random.key(3))
    s = flow.sample(50, key=jax.random.key(4))
    assert s.shape == (50, 3)
    lp = flow.log_prob(x[:20])
    assert lp.shape == (20,)


def test_sample_roundtrip_density():
    """Samples from a trained flow must land where log_prob is finite and
    the forward/inverse maps agree (invariant §2.4.8 at the Flow level)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 2)).astype(np.float32)
    data = df.DataArrays.make(x, rng=1)
    chain = df.flow_chain(
        df.coupling_block(2, [0], n=0, key=jax.random.key(5)),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    z = jnp.asarray(rng.normal(size=(30, 2)).astype(np.float32))
    xf, ldj_f = flow.forward(z)
    zb, ldj_b = flow.inverse(xf)
    np.testing.assert_allclose(np.asarray(z), np.asarray(zb), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ldj_f + ldj_b), 0.0, atol=1e-5)


def test_predict_equals_forward_first(fixture_data):
    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    z = np.random.default_rng(3).normal(size=(5, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(flow.predict(z, (-1.0,))),
        np.asarray(flow.forward(z, (-1.0,))[0]),
    )


def test_convergence_regression(fixture_data):
    """Final NLL on the reference fixture must reach the recorded level
    (≈3.28 train / 3.32 valid at 50 epochs, measured on this config —
    SURVEY.md §6 'baselines are measured, not copied')."""
    import jax

    x, theta = fixture_data
    data = df.DataArrays.make(x, theta, rng=0)
    ks = jax.random.split(jax.random.key(0), 3)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1, 2], hidden_dim_s=16, hidden_dim_t=16, key=ks[0]),
        df.coupling_layer(data, [2, 3, 4], hidden_dim_s=16, hidden_dim_t=16, key=ks[1]),
        df.coupling_layer(data, [4, 0, 1], hidden_dim_s=16, hidden_dim_t=16, key=ks[2]),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    df.train(flow, data, epochs=50, verbose=False, key=jax.random.key(1))
    assert flow.training_loss[-1] < 3.5
    assert flow.validation_loss[-1] < 3.6


def test_config_driven_experiment():
    """One-config end-to-end: split, build, train (reference defaults)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 3)).astype(np.float32)
    cfg = df.FlowConfig(
        net=df.NetConfig(hidden_dim_s=8, hidden_dim_t=8),
        train=df.TrainConfig(epochs=3, verbose=False),
        n_blocks=2,
    )
    flow, data, opt_state = df.run_experiment(cfg, x, key=jax.random.key(0))
    assert len(flow.training_loss) == 3
    assert np.all(np.isfinite(flow.training_loss))
    assert len(flow.model) == 3  # 2 blocks + normalization


def test_metrics_jsonl_logging(tmp_path):
    from densityflows_tpu.utils.logging import MetricsLogger

    rng = np.random.default_rng(4)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    data = df.DataArrays.make(x, rng=0)
    chain = df.flow_chain(df.coupling_layer(3, [0, 1], key=jax.random.key(0),
                                            hidden_dim_s=8, hidden_dim_t=8))
    flow = df.Flow(chain, data)
    path = str(tmp_path / "metrics.jsonl")
    df.train(flow, data, epochs=3, verbose=False, key=jax.random.key(1),
             metrics_log=path)
    recs = MetricsLogger(path).read()
    assert [r["epoch"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["train_nll"]) for r in recs)


def test_sample_sweep_over_theta_grid(fixture_data):
    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    thetas = np.array([[-1.0], [0.5], [2.0]], np.float32)
    out = flow.sample_sweep(thetas, 100, key=jax.random.key(0))
    assert out.shape == (3, 100, 5)
    assert np.all(np.isfinite(np.asarray(out)))
    with pytest.raises(ValueError, match="thetas must have shape"):
        flow.sample_sweep(np.zeros((3, 2), np.float32), 10)


def test_sample_sweep_sharded(fixture_data):
    from densityflows_tpu.parallel.mesh import make_mesh

    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    mesh = make_mesh()
    thetas = np.array([[-1.0], [2.0]], np.float32)
    out = flow.sample_sweep(thetas, 64, key=jax.random.key(1), mesh=mesh)
    assert out.shape == (2, 64, 5)


def test_grid_log_prob_chunked_matches_direct(fixture_data):
    """Grids larger than grid_chunk evaluate in on-device chunks; the
    result must be identical to the one-shot path."""
    x, theta = fixture_data
    flow, _ = _readme_flow(x, theta)
    vecs = tuple(np.linspace(-2, 2, k).astype(np.float32)
                 for k in (7, 6, 5, 4, 3))  # 2520 rows
    direct = np.asarray(flow.log_prob(vecs, (-1.0,)))
    chunked = np.asarray(flow.log_prob(vecs, (-1.0,), grid_chunk=128))
    assert direct.shape == (7, 6, 5, 4, 3)
    np.testing.assert_allclose(chunked, direct, rtol=2e-5, atol=2e-5)


def test_prepare_theta_one_d_always_broadcasts():
    """1-D θ of length n is ALWAYS one condition vector — even when the
    batch size equals n (the previously flip-prone shape)."""
    import jax

    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 2)).astype(np.float32)
    th = rng.normal(size=(50, 3)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    flow = df.Flow(
        df.flow_chain(df.coupling_layer(data, [0], key=jax.random.key(0))),
        data,
    )
    out = flow.prepare_theta(np.array([0.1, 0.2, 0.3], np.float32), (3,))
    assert out.shape == (3, 3)
    # all rows identical: broadcast, not per-sample
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(out[1]))
    # wrong-length 1-D raises with the explicit-shape hint
    import pytest
    with pytest.raises(ValueError, match="broadcast"):
        flow.prepare_theta(np.zeros(5, np.float32), (5,))


def test_rqs_forward_fast_path_matches_forward(fixture_data):
    """RQS forward_ (ldj-free spline fast path) equals forward()[0]."""
    import jax

    layer = df.coupling_layer(
        4, [0, 2], kind=df.RQSCouplingLayer, key=jax.random.key(3)
    )
    z = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    th = np.zeros((64, 0), np.float32)
    full, ldj = layer.forward(z, th)
    fast = layer.forward_(z, th)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(full), rtol=1e-6)
    assert np.asarray(ldj).shape == (64,)


def test_chunked_sampling_fold_matches_straight():
    """The row-chunked sampling fold (the memory bound for very large
    folds) must reproduce the straight fold exactly, including a
    non-multiple-of-chunk remainder, and the threshold routes only folds
    whose activations would pass the byte bound."""
    import jax.numpy as jnp

    from densityflows_tpu.models import flow as flow_mod

    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(200, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1, 2], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.coupling_layer(data, [3, 4, 5], key=jax.random.key(1),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.normalization_layer(x, -1.0, 1.0),
    )
    fl = df.Flow(chain, data)

    rows = 10_000  # not a multiple of the chunk
    r = fl.base.sample(jax.random.key(7), (rows,))
    theta_n = fl.prepare_theta((0.5, 0.5), (rows,))
    straight = np.asarray(flow_mod._sample_program(
        chain, None, jnp.array(r), theta_n))
    chunked = np.asarray(flow_mod._sample_program_chunked(
        chain, jnp.array(r), jnp.broadcast_to(
            theta_n, (rows, 2)).astype(np.float32)))
    np.testing.assert_allclose(chunked, straight, atol=1e-6)

    # threshold: small folds stay on the straight program; only
    # rows x width x 4B past the byte bound chunk
    assert not fl._chunk_fold(rows)
    assert not fl._chunk_fold(1 << 21)
    assert fl._chunk_fold(1 << 26)


def test_chunked_log_prob_matches_straight():
    """Row-chunked density evaluation == the straight program exactly
    (same routing lever as the sampling fold)."""
    import jax.numpy as jnp

    from densityflows_tpu.models import flow as flow_mod

    rng = np.random.default_rng(5)
    x = rng.normal(size=(150, 4)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(150, 1)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.coupling_layer(data, [2, 3], key=jax.random.key(1),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.normalization_layer(x, -1.0, 1.0),
    )
    fl = df.Flow(chain, data)
    rows = 9_000  # non-multiple of the chunk
    xe = rng.normal(size=(rows, 4)).astype(np.float32)
    theta_n = fl.prepare_theta((0.2,), (rows,))
    straight = np.asarray(flow_mod._log_prob_program(
        chain, fl.base, jnp.asarray(xe), theta_n))
    chunked = np.asarray(flow_mod._log_prob_program_chunked(
        chain, fl.base, jnp.asarray(xe),
        jnp.broadcast_to(theta_n, (rows, 1)).astype(np.float32)))
    np.testing.assert_allclose(chunked, straight, atol=1e-6)


def test_sample_sweep_chunked_routing_equality():
    """Flow.sample_sweep must produce IDENTICAL draws whether or not the
    chunked fold routes (same key ⇒ same base draws; the fold is
    deterministic), and the threshold must be the only thing deciding."""
    import jax.numpy as jnp

    from densityflows_tpu.models import flow as flow_mod

    rng = np.random.default_rng(9)
    x = rng.normal(size=(120, 4)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(120, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.normalization_layer(x, -1.0, 1.0),
    )
    fl = df.Flow(chain, data)
    thetas = np.array([[0.2, 0.4], [0.8, 0.1]], np.float32)

    per = flow_mod._FOLD_CHUNK
    out_plain = np.asarray(fl.sample_sweep(thetas, per,
                                           key=jax.random.key(3)))
    # force the chunked route by dropping the byte threshold
    orig = flow_mod._FOLD_CHUNK_BYTES
    try:
        flow_mod._FOLD_CHUNK_BYTES = 0
        assert fl._chunk_fold(2 * per)
        out_chunk = np.asarray(fl.sample_sweep(thetas, per,
                                               key=jax.random.key(3)))
    finally:
        flow_mod._FOLD_CHUNK_BYTES = orig
    np.testing.assert_allclose(out_chunk, out_plain, atol=1e-6)
