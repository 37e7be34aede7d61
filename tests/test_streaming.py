"""Native host loader + out-of-core streaming training tests."""

import numpy as np
import jax
import pytest

import densityflows_tpu as df
from densityflows_tpu import native
from densityflows_tpu.data_stream import StreamingLoader, train_streaming


def test_native_library_builds():
    """The C++ loader must compile in this environment (g++ is baked in);
    the NumPy fallback exists for toolchain-less installs only."""
    assert native.native_available()


def test_shuffle_native_matches_python_fallback():
    """Determinism contract: both paths are bit-identical permutations."""
    for seed, n in [(0, 1), (1, 17), (42, 1000), (2**63, 257)]:
        got = native.shuffle(seed, n)
        want = native._shuffle_py(seed, n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_gather_rows_matches_fancy_indexing():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        src = rng.normal(size=(500, 7)).astype(dtype)
        idx = rng.integers(0, 500, size=123)
        np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    # non-float dtypes fall back to fancy indexing
    src_i = rng.integers(0, 100, size=(50, 3)).astype(np.int32)
    idx = rng.integers(0, 50, size=20)
    np.testing.assert_array_equal(native.gather_rows(src_i, idx), src_i[idx])


def test_streaming_loader_covers_each_row_once():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(103, 4)).astype(np.float32)
    theta = np.arange(103, dtype=np.float32)[:, None]
    loader = StreamingLoader(x, theta, batchsize=16, seed=3)
    seen = []
    for xb, thb, mask in loader.epoch(0):
        assert xb.shape == (16, 4) and thb.shape == (16, 1)
        valid = mask.astype(bool)
        seen.extend(thb[valid, 0].astype(int).tolist())
        np.testing.assert_array_equal(xb[valid], x[thb[valid, 0].astype(int)])
    assert sorted(seen) == list(range(103))
    # a different epoch gives a different order, same coverage
    seen2 = [int(v) for _, thb, m in loader.epoch(1)
             for v in thb[m.astype(bool), 0]]
    assert sorted(seen2) == list(range(103))
    assert seen2 != seen


def test_streaming_loader_host_sharding_partitions_globally():
    """Per-host shards of the same epoch are disjoint and cover all rows."""
    x = np.arange(40, dtype=np.float32)[:, None]
    shards = []
    for h in range(3):
        loader = StreamingLoader(x, batchsize=8, seed=7, host_id=h,
                                 num_hosts=3)
        rows = [int(v) for xb, _, m in loader.epoch(0)
                for v in xb[m.astype(bool), 0]]
        assert len(rows) == loader.rows_per_host
        shards.append(rows)
    allrows = sorted(r for s in shards for r in s)
    assert allrows == list(range(40))


def test_streaming_loader_memmap_source(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, x)
    xm = np.load(path, mmap_mode="r")
    loader = StreamingLoader(xm, batchsize=32, shuffle=False)
    xb, thb, mask = next(iter(loader))
    np.testing.assert_array_equal(xb, x[:32])
    assert thb.shape == (32, 0)


def test_streaming_loader_validates_inputs():
    x = np.zeros((10, 2), np.float32)
    with pytest.raises(ValueError):
        StreamingLoader(np.zeros((10,), np.float32))
    with pytest.raises(ValueError):
        StreamingLoader(x, np.zeros((9, 1), np.float32))
    with pytest.raises(ValueError):
        StreamingLoader(x, host_id=2, num_hosts=2)


def test_train_streaming_converges_and_matches_contract():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(800, 3)) * np.array([1.0, 0.5, 2.0])).astype(np.float32)
    theta = rng.choice([-1.0, 2.0], size=(800, 1)).astype(np.float32)
    data = df.DataArrays.make(x, theta, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1], key=jax.random.key(0)),
        df.coupling_layer(data, [1, 2], key=jax.random.key(1)),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    xv = x[:100]
    opt_state = train_streaming(
        flow, x, theta, epochs=6, batchsize=64, seed=5,
        valid_data=(xv, theta[:100]), verbose=False,
    )
    assert opt_state is not None
    assert len(flow.training_loss) == 6
    assert len(flow.validation_loss) == 6
    assert np.all(np.isfinite(flow.training_loss))
    assert flow.training_loss[-1] < flow.training_loss[0]
    # streamed flow samples fine
    s = np.asarray(flow.sample((500,), (-1.0,), key=jax.random.key(2)))
    assert s.shape == (500, 3) and np.isfinite(s).all()


def test_train_streaming_unconditional():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 2)).astype(np.float32)
    data = df.DataArrays.make(x, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(2, [0], key=jax.random.key(0)),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    train_streaming(flow, x, epochs=3, batchsize=32, verbose=False)
    assert len(flow.training_loss) == 3
    assert np.all(np.isfinite(flow.training_loss))


def test_streaming_with_mesh_matches_unsharded():
    """train_streaming(mesh=…) shards each batch over the data axis; the
    per-batch losses and final params must match the unsharded run (same
    batches, GSPMD only changes placement)."""
    import densityflows_tpu as df
    from densityflows_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    th = rng.uniform(0, 1, size=(300, 1)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)

    def build():
        chain = df.flow_chain(
            df.coupling_block(data, None, key=jax.random.key(0),
                              hidden_dim_s=8, hidden_dim_t=8),
            df.normalization_layer(x, -1.0, 1.0),
        )
        return df.Flow(chain, data)

    import optax

    f1, f2 = build(), build()
    df.train_streaming(f1, x, th, optax.adam(1e-3), epochs=2, batchsize=64,
                       seed=3, verbose=False)
    df.train_streaming(f2, x, th, optax.adam(1e-3), epochs=2, batchsize=64,
                       seed=3, verbose=False, mesh=make_mesh())
    np.testing.assert_allclose(f1.train_loss, f2.train_loss, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(f1.model),
                    jax.tree_util.tree_leaves(f2.model)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
