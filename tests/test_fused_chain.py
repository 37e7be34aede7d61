"""Whole-chain fold kernel vs the per-layer jnp fold.

Exercises ``models/fused_chain.py`` + ``ops/pallas_chain.py`` in the
Pallas interpreter on CPU: value/ldj parity for forward/inverse/sampling
folds over a mixed chain (couplings, blocks, normalization, actnorm,
permutation, LU-linear, logit), gradient parity through the custom-VJP
backward, row and width padding, bf16 parameters, the router as a pure
function, and one test that compiles the kernel for the GPU (marked
``gpu``; it skips without a card).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import densityflows_tpu as df
from densityflows_tpu.models import fused_chain as fc
from densityflows_tpu.models.fused_chain import (
    apply_fused,
    chain_is_fusable,
    maybe_apply_fused,
    use_fused_chain,
)
from densityflows_tpu.ops.mlp import MLP
from densityflows_tpu.ops.pallas_chain import pow2_width, tile_shape


def _mixed_chain(d=6, n=2, key=0):
    ks = jax.random.split(jax.random.key(key), 4)
    rng = np.random.default_rng(0)
    x_ref = rng.normal(size=(64, d)).astype(np.float32) * 2.0 + 0.5
    return df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], n=n, key=ks[0], hidden_dim_s=16,
                          hidden_dim_t=16, zero_init_final=False),
        df.actnorm_layer(x_ref),
        df.coupling_block(d, None, n=n, key=ks[1], hidden_dim_s=16,
                          hidden_dim_t=16, zero_init_final=False),
        df.permutation_layer(d, key=ks[2]),
        df.coupling_layer(d, [d - 3, d - 2, d - 1], n=n,
                          kind=df.NICECouplingLayer,
                          key=ks[3], hidden_dim_t=16, zero_init_final=False),
        df.invertible_linear_layer(d, key=ks[2]),
        df.normalization_layer(x_ref, -1.0, 1.0),
    )


def _small_chain(d=4, n=1, hidden=8):
    rng = np.random.default_rng(1)
    x_ref = rng.normal(size=(64, d)).astype(np.float32)
    return df.flow_chain(
        df.coupling_layer(d, [0, 1], n=n, key=jax.random.key(0),
                          hidden_dim_s=hidden, hidden_dim_t=hidden,
                          zero_init_final=False),
        df.normalization_layer(x_ref, -1.0, 1.0),
    )


def _inputs(d=6, n=2, rows=37, key=5):
    x = jax.random.normal(jax.random.key(key), (rows, d), jnp.float32) * 0.5
    theta = jax.random.uniform(jax.random.key(key + 1), (rows, n))
    return x, theta


def _ref(chain, y, theta, dirn, with_ldj=True):
    with jax.default_matmul_precision("highest"):
        return fc._jnp_chain(chain, y, theta, dirn, with_ldj)


@pytest.mark.parametrize("dirn", ["fwd", "inv"])
def test_chain_matches_oracle(dirn):
    chain = _mixed_chain()
    x, theta = _inputs()
    assert chain_is_fusable(chain, 6)
    out = apply_fused(chain, x, theta, dirn, True, interpret=True)
    ref = _ref(chain, x, theta, dirn)
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[1], ref[1], rtol=2e-5, atol=2e-5)


def test_sampling_fold_matches_oracle():
    chain = _mixed_chain()
    z, theta = _inputs(key=9)
    out = apply_fused(chain, z, theta, "fwd", False, interpret=True)
    ref = _ref(chain, z, theta, "fwd", False)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_logit_tail_matches_oracle():
    d, n = 16, 1  # logit needs an unpadded width
    lo = np.zeros(d, np.float32)
    hi = np.ones(d, np.float32) * 3.0
    chain = df.flow_chain(
        df.coupling_layer(d, list(range(8)), n=n, key=jax.random.key(0),
                          hidden_dim_s=16, hidden_dim_t=16,
                          zero_init_final=False),
        df.logit_layer((lo, hi)),
    )
    z, theta = _inputs(d=d, n=n, rows=21, key=3)
    out = apply_fused(chain, z, theta, "fwd", True, interpret=True)
    ref = _ref(chain, z, theta, "fwd")
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[1], ref[1], rtol=2e-5, atol=2e-4)
    x = out[0]
    out_i = apply_fused(chain, x, theta, "inv", True, interpret=True)
    ref_i = _ref(chain, x, theta, "inv")
    np.testing.assert_allclose(out_i[0], ref_i[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out_i[1], ref_i[1], rtol=2e-5, atol=2e-4)


def test_logit_refuses_padded_width():
    d = 4
    chain = df.flow_chain(
        df.coupling_layer(d, [0, 1], n=1, key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.logit_layer((np.zeros(d, np.float32), np.ones(d, np.float32))),
    )
    assert not chain_is_fusable(chain, d)


def test_roundtrip_through_fused_chain():
    chain = _mixed_chain()
    z, theta = _inputs(key=11)
    x, ldj_f = apply_fused(chain, z, theta, "fwd", True, interpret=True)
    z2, ldj_b = apply_fused(chain, x, theta, "inv", True, interpret=True)
    np.testing.assert_allclose(z2, z, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ldj_f + ldj_b, np.zeros(len(z)), atol=1e-4)


def test_gradients_fall_back_to_oracle():
    chain = _mixed_chain(d=4, n=1, key=2)
    x, theta = _inputs(d=4, n=1, rows=16, key=7)

    def loss_fused(c, xx, tt):
        z, ldj = apply_fused(c, xx, tt, "inv", True, interpret=True)
        return jnp.sum(z**2) - jnp.sum(ldj)

    def loss_ref(c, xx, tt):
        z, ldj = fc._jnp_chain(c, xx, tt, "inv", True)
        return jnp.sum(z**2) - jnp.sum(ldj)

    g_fused = jax.grad(loss_fused, argnums=(0, 1, 2))(chain, x, theta)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(chain, x, theta)
    for a, b in zip(jax.tree_util.tree_leaves(g_fused),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_unconditional_chain():
    d = 5
    chain = df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], n=0, key=jax.random.key(1),
                          hidden_dim_s=8, hidden_dim_t=8,
                          zero_init_final=False),
        df.coupling_layer(d, [2, 3, 4], n=0, key=jax.random.key(2),
                          hidden_dim_s=8, hidden_dim_t=8,
                          zero_init_final=False),
    )
    x = jax.random.normal(jax.random.key(3), (19, d), jnp.float32)
    theta = jnp.zeros((19, 0), jnp.float32)
    out = apply_fused(chain, x, theta, "inv", True, interpret=True)
    ref = _ref(chain, x, theta, "inv")
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[1], ref[1], rtol=2e-5, atol=2e-5)


def test_unsupported_chain_returns_none():
    d, n = 4, 1
    chain = df.flow_chain(
        df.coupling_layer(d, [0, 1], n=n, kind=df.RQSCouplingLayer,
                          key=jax.random.key(0)),
    )
    assert not chain_is_fusable(chain, d)
    x, theta = _inputs(d=d, n=n, rows=8, key=1)
    assert maybe_apply_fused(chain, x, theta, "fwd", True) is None


@pytest.fixture
def kernel_routed(monkeypatch):
    """Route every fold to the kernel, run in the Pallas interpreter;
    yields the list of kernel calls made."""
    calls = []
    apply = fc.apply_fused

    def interpreted(*args, **kw):
        calls.append(args[3])
        return apply(*args, **kw, interpret=True)

    monkeypatch.setattr(fc, "use_fused_chain", lambda *a: True)
    monkeypatch.setattr(fc, "apply_fused", interpreted)
    jax.clear_caches()  # the route is read at trace time
    yield calls
    jax.clear_caches()


def _fixture_flow(fixture_data, zero_init_final):
    x_np, th_np = fixture_data
    data = df.DataArrays.make(x_np, th_np, rng=0)
    ks = jax.random.split(jax.random.key(0), 2)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1, 2], key=ks[0], hidden_dim_s=8,
                          hidden_dim_t=8, zero_init_final=zero_init_final),
        df.coupling_layer(data, [2, 3, 4], key=ks[1], hidden_dim_s=8,
                          hidden_dim_t=8, zero_init_final=zero_init_final),
        df.normalization_layer(x_np, -1.0, 1.0),
    )
    return df.Flow(chain, data), x_np


def test_flow_entry_points_use_fused_path(fixture_data, kernel_routed):
    """End-to-end: Flow.log_prob / sample agree between the kernel route
    and XLA's fold, and the kernel route really runs the kernel."""
    flow, x_np = _fixture_flow(fixture_data, False)
    lp_fused = flow.log_prob(x_np[:50], (-1.0,))
    s_fused = flow.sample((64,), (-1.0,), key=jax.random.key(5))
    assert set(kernel_routed) == {"inv", "fwd"}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(fc, "use_fused_chain", lambda *a: False)
        jax.clear_caches()
        lp_ref = flow.log_prob(x_np[:50], (-1.0,))
        s_ref = flow.sample((64,), (-1.0,), key=jax.random.key(5))
    np.testing.assert_allclose(lp_fused, lp_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s_fused, s_ref, rtol=2e-5, atol=2e-5)


def test_flow_sample_fused_matches_flow_contract(fixture_data,
                                                 kernel_routed):
    """Flow.sample through the kernel keeps the API contract (shape, θ
    broadcast, dims tuple, per-row θ)."""
    flow, _ = _fixture_flow(fixture_data, True)
    s = flow.sample((2, 5, 7), (-1.0,), key=jax.random.key(1))
    assert s.shape == (2, 5, 7, 5)
    assert np.all(np.isfinite(s))
    th = np.full((64, 1), 2.0, np.float32)
    s2 = flow.sample((64,), th, key=jax.random.key(2))
    assert s2.shape == (64, 5)
    assert np.all(np.isfinite(s2))
    assert kernel_routed == ["fwd", "fwd"]


def test_clamped_chain_matches_oracle():
    """max_log_scale tanh-clamped couplings (split and joint) in both
    directions, clamps low enough to exercise the nonlinear region."""
    d, n = 6, 2
    ks = jax.random.split(jax.random.key(3), 3)
    chain = df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], n=n, key=ks[0], hidden_dim_s=16,
                          hidden_dim_t=16, zero_init_final=False,
                          max_log_scale=0.2),
        df.coupling_layer(d, [3, 4, 5], n=n, key=ks[1],
                          joint_conditioner=True, hidden_dim_s=16,
                          hidden_dim_t=16, zero_init_final=False,
                          max_log_scale=0.5),
    )
    x, theta = _inputs(d, n)
    for dirn in ("fwd", "inv"):
        y_f, ldj_f = apply_fused(chain, x, theta, dirn, True, interpret=True)
        y_o, ldj_o = _ref(chain, x, theta, dirn)
        np.testing.assert_allclose(np.asarray(y_f), np.asarray(y_o),
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(ldj_f), np.asarray(ldj_o),
                                   atol=2e-5)


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 4097])
def test_row_padding(rows):
    """Rows that are not a tile multiple are zero-padded and sliced
    back; every real row matches the jnp fold."""
    chain = _small_chain()
    x, theta = _inputs(d=4, n=1, rows=rows, key=rows)
    y, ldj = apply_fused(chain, x, theta, "inv", True, interpret=True)
    assert y.shape == (rows, 4) and ldj.shape == (rows,)
    ref = _ref(chain, x, theta, "inv")
    np.testing.assert_allclose(y, ref[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ldj, ref[1], rtol=2e-5, atol=2e-5)


def test_batch_dims_flatten():
    chain = _small_chain()
    x = jax.random.normal(jax.random.key(0), (3, 5, 4))
    theta = jax.random.uniform(jax.random.key(1), (3, 5, 1))
    y, ldj = apply_fused(chain, x, theta, "fwd", True, interpret=True)
    assert y.shape == (3, 5, 4) and ldj.shape == (3, 5)
    ref = _ref(chain, x.reshape(15, 4), theta.reshape(15, 1), "fwd")
    np.testing.assert_allclose(y.reshape(15, 4), ref[0], atol=2e-5)


def test_bf16_params():
    """bf16 conditioner weights: the kernel upcasts them and runs f32
    arithmetic, so it agrees with the f32 fold over the SAME (rounded)
    weights to f32 accuracy."""
    chain = df.flow_chain(
        df.coupling_layer(6, [0, 1, 2], n=2, key=jax.random.key(4),
                          hidden_dim_s=16, hidden_dim_t=16,
                          zero_init_final=False, dtype=jnp.bfloat16),
    )
    x, theta = _inputs()
    y, ldj = apply_fused(chain, x, theta, "inv", True, interpret=True)
    assert y.dtype == jnp.float32
    up = df.cast_conditioners(chain, jnp.float32)
    ref = _ref(up, x, theta, "inv")
    np.testing.assert_allclose(y, ref[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ldj, ref[1], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_sub,hidden,joint", [
    (1, 32, False), (3, 32, False), (2, 256, False), (3, 256, True)])
def test_conditioner_depths_and_hidden_chunks(n_sub, hidden, joint):
    """Conditioners of 2–4 dense layers, and hidden widths that span
    several column chunks, through a run of stacked couplings."""
    d, n = 8, 2
    keys = jax.random.split(jax.random.key(n_sub), 2)
    chain = df.flow_chain(*[
        df.coupling_block(d, None, n=n, key=k, hidden_dim_s=hidden,
                          hidden_dim_t=hidden, n_sublayers_s=n_sub,
                          n_sublayers_t=n_sub, joint_conditioner=joint,
                          zero_init_final=False) for k in keys])
    chain = jax.tree_util.tree_map(
        lambda m: MLP(m.weights[:-1] + (m.weights[-1] * 0.2,), m.biases,
                      m.activation) if isinstance(m, MLP) else m,
        chain, is_leaf=lambda m: isinstance(m, MLP))
    x, theta = _inputs(d=d, n=n, rows=23, key=4)
    for dirn in ("fwd", "inv"):
        y, ldj = apply_fused(chain, x, theta, dirn, True, interpret=True)
        ref = _ref(chain, x, theta, dirn)
        np.testing.assert_allclose(y, ref[0], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(ldj, ref[1], rtol=2e-5, atol=2e-4)


def test_plan_stacks_runs_of_couplings():
    """Couplings of one signature fold into one looped run; other
    elements split runs."""
    d, n = 8, 2
    keys = jax.random.split(jax.random.key(0), 4)
    chain = df.flow_chain(
        *[df.coupling_block(d, None, n=n, key=k, hidden_dim_s=32,
                            hidden_dim_t=32) for k in keys[:3]],
        df.permutation_layer(d, key=keys[3]),
        df.coupling_block(d, None, n=n, key=keys[3], hidden_dim_s=32,
                          hidden_dim_t=32),
        df.normalization_layer(np.eye(d, dtype=np.float32), -1.0, 1.0),
    )
    sh = fc._Shapes(d, n, 32)
    plan, params, _ = fc._plan_params(chain, "inv", sh)
    assert [op[0] for op in plan] == ["affine", "couplings", "linear",
                                      "couplings"]
    assert plan[1][1] == 2 and plan[3][1] == 6
    n_c = fc.op_param_count(plan[1])  # 2 nets x (2 first + 2 + 3 biases)
    assert n_c == 14 and len(params) == 2 + n_c + 1 + n_c
    assert {p.shape[0] for p in params[2:2 + n_c]} == {2}
    assert {p.shape[0] for p in params[3 + n_c:]} == {6}


@pytest.mark.parametrize("platform,rows,d,hidden,joint,want", [
    ("gpu", 1 << 18, 16, 64, False, True),
    ("gpu", 1 << 18, 32, 64, False, True),
    ("gpu", 1 << 20, 8, 32, False, True),
    ("cpu", 1 << 18, 16, 64, False, False),
    ("gpu", 1 << 18, 16, 64, True, False),
    ("gpu", 1 << 12, 16, 64, False, False),
    ("gpu", 1 << 18, 5, 16, False, False),
    ("gpu", 1 << 18, 64, 64, False, False),
    ("gpu", 1 << 18, 16, 128, False, False),
    ("gpu", 1 << 18, 32, 256, False, False),
    ("gpu", 1 << 18, 128, 512, True, False),
])
def test_router_is_a_function_of_observables(platform, rows, d, hidden,
                                             joint, want):
    assert use_fused_chain(platform, rows, d, hidden, joint) is want


def test_router_declines_on_cpu(fixture_data):
    """On the CPU the public entry points keep the XLA fold."""
    x_np, th_np = fixture_data
    data = df.DataArrays.make(x_np, th_np, rng=0)
    flow = df.Flow(_small_chain(d=5, n=1, hidden=64), data)
    assert not flow._kernel_fold(1 << 18)
    x = jnp.asarray(x_np[:8])
    th = jnp.zeros((8, 1))
    assert maybe_apply_fused(flow.model, x, th, "inv", True) is None


def test_tile_rules():
    assert [pow2_width(w) for w in (1, 5, 16, 17, 32, 100)] == [
        16, 16, 16, 32, 32, 128]
    for h in (16, 64, 128, 256, 512, 1024):
        tb, c, warps, stages = tile_shape(h)
        assert tb >= 16 and tb & (tb - 1) == 0  # Triton blocks: powers of 2
        assert h % c == 0 and 16 <= c <= 128 and warps in (4, 8)
        assert stages == 1 or h <= 256


@pytest.mark.gpu
@pytest.mark.parametrize("joint", [False, True])
def test_kernel_on_gpu_matches_reference(joint):
    """Compiled for the card at a width the router sends to it: TF32
    kernel vs the float32 fold at highest precision (tolerance: TF32
    operand rounding, about 1e-3 relative per dot, through 8 couplings)."""
    d, n, hidden = 32, 8, 64
    rng = np.random.default_rng(0)
    x_ref = rng.normal(size=(512, d)).astype(np.float32)
    keys = jax.random.split(jax.random.key(0), 4)
    chain = df.flow_chain(
        *[df.coupling_block(d, None, n=n, key=k, hidden_dim_s=hidden,
                            hidden_dim_t=hidden, joint_conditioner=joint,
                            zero_init_final=False)
          for k in keys],
        df.normalization_layer(x_ref, -1.0, 1.0),
    )
    # damp the final conditioner layers so exp(s) stays O(1)
    chain = jax.tree_util.tree_map(
        lambda m: MLP(m.weights[:-1] + (m.weights[-1] * 0.05,), m.biases,
                      m.activation) if isinstance(m, MLP) else m,
        chain, is_leaf=lambda m: isinstance(m, MLP))
    x, theta = _inputs(d=d, n=n, rows=8192, key=2)
    y, ldj = apply_fused(chain, x, theta, "inv", True)
    ref = _ref(chain, x, theta, "inv")
    np.testing.assert_allclose(y, ref[0], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(ldj, ref[1], rtol=1e-2, atol=1e-2)
