"""Multi-device sharding tests on the virtual 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8 via conftest) — the
standard way to validate pjit/mesh code without several accelerators (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import densityflows_tpu as df
from densityflows_tpu.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8, "conftest must provide 8 virtual devices"
    return make_mesh((8,), ("data",))


@pytest.fixture(scope="module")
def mesh2d():
    return make_mesh((4, 2), ("data", "model"))


def _flow_and_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    th = rng.uniform(0, 1, size=(512, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=1)
    chain = df.flow_chain(
        df.coupling_block(data, [0, 2], key=jax.random.key(2)),
        df.normalization_layer(x, -1.0, 1.0),
    )
    return df.Flow(chain, data), data, x, th


def test_sharded_log_prob_matches_single_device(mesh):
    flow, data, x, th = _flow_and_data()
    lp_single = np.asarray(flow.log_prob(x, th))

    xs, ths = shard_batch(mesh, jnp.asarray(x), jnp.asarray(th))
    assert xs.sharding.spec == data_sharding(mesh, 2).spec
    lp_sharded = np.asarray(flow.log_prob(xs, ths))
    np.testing.assert_allclose(lp_single, lp_sharded, atol=1e-5)


def test_dp_training_matches_unsharded(mesh):
    """Data-parallel training over the mesh must produce the same model as
    single-device training (XLA inserts the gradient psum; same math)."""
    optimizer = optax.adam(1e-3)

    flow_a, data_a, x, th = _flow_and_data()
    df.train(flow_a, data_a, optimizer, epochs=2, batchsize=128, shuffle=False,
             verbose=False, key=jax.random.key(5))

    flow_b, data_b, _, _ = _flow_and_data()
    df.train(flow_b, data_b, optimizer, epochs=2, batchsize=128, shuffle=False,
             verbose=False, key=jax.random.key(5), mesh=mesh)

    np.testing.assert_allclose(flow_a.train_loss, flow_b.train_loss, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(flow_a.log_prob(x[:16], th[:16])),
        np.asarray(flow_b.log_prob(x[:16], th[:16])),
        atol=1e-4,
    )


def test_sharded_sampling(mesh):
    """Sampling with the particle axis sharded over the mesh: the base draw
    is placed on the data axis and the whole forward sweep stays sharded."""
    flow, data, x, th = _flow_and_data()
    n = 800
    key = jax.random.key(7)
    r = flow.base.sample(key, (n,))
    r = jax.device_put(r, data_sharding(mesh, 2))
    theta = flow.prepare_theta((0.5, 0.5), (n,))
    theta = jax.device_put(theta, data_sharding(mesh, 2))
    out = jax.jit(lambda m, rr, tt: m.forward_(rr, tt))(flow.model, r, theta)
    assert out.shape == (n, 4)
    # output stays sharded over the data axis — no implicit all-gather
    assert out.sharding.is_equivalent_to(data_sharding(mesh, 2), 2)


def test_replicated_params_under_mesh(mesh):
    flow, *_ = _flow_and_data()
    placed = jax.device_put(flow.model, replicated(mesh))
    leaves = jax.tree_util.tree_leaves(placed)
    assert all(l.sharding.is_fully_replicated for l in leaves)


def test_global_batch_from_host_local(mesh):
    from densityflows_tpu.parallel.mesh import (
        global_batch_from_host_local, host_local_slice,
    )

    n = 64
    sl = host_local_slice(n)
    assert sl == slice(0, 64)  # single process owns everything
    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    g = global_batch_from_host_local(mesh, arr[sl])
    assert g.shape == (n, 3)
    np.testing.assert_array_equal(np.asarray(g), arr)
    assert len(g.sharding.device_set) == 8


def test_evaluate_splits(mesh):
    import jax
    import densityflows_tpu as df
    from densityflows_tpu.train import evaluate

    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    th = rng.uniform(size=(200, 1)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0, f_training=0.7, f_validation=0.2)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8))
    flow = df.Flow(chain, data)
    for split in ("training", "validation", "testing"):
        v = evaluate(flow, data, split)
        assert np.isfinite(v)


def test_scaling_report_runs(mesh):
    """Weak-scaling harness executes at 1/2/4/8 virtual devices and
    returns sane throughput numbers (the ≥80%-linear protocol harness —
    efficiency itself is not asserted on CPU)."""
    import jax
    import densityflows_tpu as df
    from densityflows_tpu.parallel.scaling import scaling_report

    def make_model(key):
        return df.flow_chain(
            df.coupling_block(4, None, n=1, key=key,
                              hidden_dim_s=8, hidden_dim_t=8))

    pts = scaling_report(make_model, d=4, n_cond=1,
                         per_device_batch=64, reps=2,
                         device_counts=[1, 2, 8])
    assert [p.n_devices for p in pts] == [1, 2, 8]
    for p in pts:
        assert p.train_samples_per_sec > 0
        assert p.sample_draws_per_sec > 0
    assert pts[0].train_efficiency == 1.0


def test_systematic_resample_sharded_matches_reference(mesh):
    """Ring-ppermute sharded resampler == single-device prefix-sum
    resampler for the same stratified draw (SURVEY.md §7 hard parts)."""
    import jax
    import jax.numpy as jnp
    import densityflows_tpu as df
    from densityflows_tpu.parallel.mesh import shard_batch
    from densityflows_tpu.parallel.resample import systematic_resample_sharded

    n, d = 256, 3
    key = jax.random.key(0)
    lw = jax.random.normal(jax.random.key(1), (n,))
    x = jax.random.normal(jax.random.key(2), (n, d))

    idx = df.systematic_resample(lw, key)
    expected = np.asarray(x)[np.asarray(idx)]

    lw_s, x_s = shard_batch(mesh, lw, x)
    out = systematic_resample_sharded(lw_s, x_s, key, mesh)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-6)


def test_systematic_resample_sharded_degenerate_weights(mesh):
    """All mass on one particle → every output row equals it."""
    import jax
    import jax.numpy as jnp
    from densityflows_tpu.parallel.mesh import shard_batch
    from densityflows_tpu.parallel.resample import systematic_resample_sharded

    n, d = 64, 2
    lw = jnp.full((n,), -1e9).at[37].set(0.0)
    x = jax.random.normal(jax.random.key(3), (n, d))
    lw_s, x_s = shard_batch(mesh, lw, x)
    out = systematic_resample_sharded(lw_s, x_s, jax.random.key(4), mesh)
    np.testing.assert_allclose(
        np.asarray(out), np.broadcast_to(np.asarray(x[37]), (n, d)), rtol=1e-6
    )


def test_tp_training_matches_replicated(mesh2d):
    """Megatron-style TP on the conditioner MLPs gives the same loss as
    replicated params (collectives inserted by GSPMD)."""
    import jax
    import jax.numpy as jnp
    import optax
    import densityflows_tpu as df
    from densityflows_tpu.parallel.mesh import (
        data_sharding, replicated, shard_params_tp,
    )
    from densityflows_tpu.train import make_train_step

    rng = np.random.default_rng(0)
    d, n, hidden, batch = 4, 1, 16, 32
    chain = df.flow_chain(
        df.coupling_block(d, None, n=n, key=jax.random.key(0),
                          hidden_dim_s=hidden, hidden_dim_t=hidden))
    base = df.StandardNormal(d)
    opt = optax.adam(1e-3)
    x = rng.normal(size=(batch, d)).astype(np.float32)
    th = rng.uniform(size=(batch, n)).astype(np.float32)
    mask = np.ones((batch,), np.float32)

    def run(params_placer):
        # fresh buffers per run: device_put may alias, and the donating
        # train step would delete the shared originals
        model = params_placer(jax.tree_util.tree_map(jnp.array, chain))
        opt_state = jax.device_put(opt.init(model), replicated(mesh2d))
        step = make_train_step(opt)
        xs = jax.device_put(x, data_sharding(mesh2d, 2))
        ths = jax.device_put(th, data_sharding(mesh2d, 2))
        ms = jax.device_put(mask, data_sharding(mesh2d, 1))
        _, _, loss = step(model, opt_state, base, xs, ths, ms)
        return float(loss)

    loss_rep = run(lambda m: jax.device_put(m, replicated(mesh2d)))
    loss_tp = run(lambda m: shard_params_tp(mesh2d, m))
    np.testing.assert_allclose(loss_tp, loss_rep, rtol=1e-5)


def test_128d_flow_dp_training(mesh):
    """BASELINE config 5 shape: 128-D flow, data-parallel batch over the
    mesh, one jitted step executes and the loss is finite."""
    import jax
    import jax.numpy as jnp
    import optax
    import densityflows_tpu as df
    from densityflows_tpu.parallel.mesh import data_sharding, replicated
    from densityflows_tpu.train import make_train_step

    d, n, hidden, batch = 128, 4, 64, 256
    rng = np.random.default_rng(0)
    chain = df.flow_chain(
        df.coupling_block(d, None, n=n, key=jax.random.key(0),
                          hidden_dim_s=hidden, hidden_dim_t=hidden),
        df.coupling_block(d, None, n=n, key=jax.random.key(1),
                          hidden_dim_s=hidden, hidden_dim_t=hidden),
    )
    base = df.StandardNormal(d)
    opt = optax.adam(1e-3)
    model = jax.device_put(chain, replicated(mesh))
    opt_state = jax.device_put(opt.init(model), replicated(mesh))
    x = jax.device_put(rng.normal(size=(batch, d)).astype(np.float32),
                       data_sharding(mesh, 2))
    th = jax.device_put(rng.uniform(size=(batch, n)).astype(np.float32),
                        data_sharding(mesh, 2))
    mask = jax.device_put(np.ones((batch,), np.float32),
                          data_sharding(mesh, 1))
    step = make_train_step(opt)
    model, opt_state, loss = step(model, opt_state, base, x, th, mask)
    assert np.isfinite(float(loss))
    # sampling sweep at 128-D
    r = jax.device_put(rng.normal(size=(batch, d)).astype(np.float32),
                       data_sharding(mesh, 2))
    out = jax.jit(lambda m, rr, tt: m.forward_(rr, tt))(model, r, th)
    assert out.shape == (batch, d)
    assert np.all(np.isfinite(np.asarray(out)))


def test_donated_buffers_are_consumed():
    """Donation contract of the jitted step: the donated model buffers are
    invalidated by the call (the aliasing hazard the reference handles by
    in-place convention, SURVEY.md §5 'race detection')."""
    import jax
    import jax.numpy as jnp
    import optax
    import densityflows_tpu as df
    from densityflows_tpu.train import make_train_step

    chain = df.flow_chain(
        df.coupling_layer(2, [0], key=jax.random.key(0),
                          hidden_dim_s=4, hidden_dim_t=4))
    base = df.StandardNormal(2)
    opt = optax.adam(1e-3)
    opt_state = opt.init(chain)
    step = make_train_step(opt)
    x = jnp.zeros((8, 2))
    th = jnp.zeros((8, 0))
    mask = jnp.ones((8,))
    new_model, new_opt, _ = step(chain, opt_state, base, x, th, mask)
    old_leaf = jax.tree_util.tree_leaves(chain)[0]
    with pytest.raises(RuntimeError, match="deleted"):
        _ = np.asarray(old_leaf)  # donated buffer must be gone


def test_pod_config_128d_smoke():
    """BASELINE config 5 shape — 128-D conditional flow, DP-mesh training +
    θ-grid sampling sweep — at reduced scale on the 8-virtual-device rig
    (the real thing differs only in mesh size and row counts; the
    MaskedMLP-descriptor static aux keeps d=128 trace time sane,
    docs/design.md §9)."""
    import densityflows_tpu as df
    from densityflows_tpu.parallel.mesh import make_mesh

    d, n_cond = 128, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, d)).astype(np.float32)
    th = rng.uniform(0, 1, size=(256, n_cond)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_block(data, None, key=jax.random.key(0),
                          hidden_dim_s=64, hidden_dim_t=64,
                          joint_conditioner=True),
        df.maf_layer(d, n=n_cond, key=jax.random.key(1), hidden_dim=64),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    mesh = make_mesh()
    df.train(flow, data, epochs=2, batchsize=64, mesh=mesh,
             key=jax.random.key(2), verbose=False)
    assert np.isfinite(flow.train_loss).all()

    thetas = rng.uniform(0.2, 0.8, size=(3, n_cond)).astype(np.float32)
    sweep = flow.sample_sweep(thetas, 16, key=jax.random.key(3), mesh=mesh)
    assert sweep.shape == (3, 16, d)
    assert np.isfinite(np.asarray(sweep)).all()

    lp = flow.log_prob(jnp.asarray(x[:32]), th[:32])
    assert np.isfinite(np.asarray(lp)).all()


def test_flow_sample_and_log_prob_mesh_match_unsharded():
    """Flow.sample(mesh=…)/log_prob(mesh=…) shard the particle axis; the
    log_prob values must equal the unsharded ones exactly, and the
    sharded sample must be finite and moment-consistent."""
    import densityflows_tpu as df
    from densityflows_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    th = rng.uniform(0, 1, size=(200, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    flow = df.Flow(
        df.flow_chain(
            df.coupling_block(data, None, key=jax.random.key(0),
                              hidden_dim_s=8, hidden_dim_t=8,
                              zero_init_final=False),
            df.normalization_layer(x, -1.0, 1.0),
        ),
        data,
    )
    mesh = make_mesh()

    xq = jnp.asarray(x[:101])  # odd row count: exercises the pad+slice
    lp0 = np.asarray(flow.log_prob(xq, th[:101]))
    lp1 = np.asarray(flow.log_prob(xq, th[:101], mesh=mesh))
    np.testing.assert_allclose(lp0, lp1, rtol=1e-6, atol=1e-6)

    s = np.asarray(flow.sample((640,), (0.3, 0.7), key=jax.random.key(1),
                               mesh=mesh))
    assert s.shape == (640, 4)
    assert np.isfinite(s).all()
    s0 = np.asarray(flow.sample((640,), (0.3, 0.7), key=jax.random.key(1)))
    # same key, same draw stream → identical samples modulo placement
    np.testing.assert_allclose(s0, s, rtol=1e-6, atol=1e-6)

    with pytest.raises(ValueError, match="grid form"):
        flow.log_prob((np.linspace(-1, 1, 4),) * 4, (0.3, 0.7), mesh=mesh)
