"""JointRNVPCouplingLayer: the two-headed conditioner parameterization.

Same coupling math as the split-net RNVP layer (reference
src/affine/RNVP.jl:77-96) with ONE MLP emitting (s ‖ t). Exactness is
tested by block-diagonal embedding: a joint net whose hidden layers are
the direct sum of a split layer's s_net/t_net hidden layers reproduces
the split layer's outputs, ldjs, and gradients bit-close.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import densityflows_tpu as df
from densityflows_tpu.ops.mlp import MLP


def _joint_from_split(split: df.RNVPCouplingLayer) -> df.JointRNVPCouplingLayer:
    """Embed split s/t nets into one joint net via block-diagonal hidden
    layers: hidden width H_s + H_t, first layer concat, output (s ‖ t)."""
    s, t = split.s_net, split.t_net
    n_layers = len(s.weights)
    assert len(t.weights) == n_layers and s.activation == t.activation
    weights, biases = [], []
    for i in range(n_layers):
        ws, wt = s.weights[i], t.weights[i]
        if i == 0:
            w = jnp.concatenate([ws, wt], axis=1)
        else:
            w = jnp.block([
                [ws, jnp.zeros((ws.shape[0], wt.shape[1]), ws.dtype)],
                [jnp.zeros((wt.shape[0], ws.shape[1]), wt.dtype), wt],
            ])
        weights.append(w)
        biases.append(jnp.concatenate([s.biases[i], t.biases[i]]))
    st_net = MLP(tuple(weights), tuple(biases), s.activation)
    return df.JointRNVPCouplingLayer(st_net, split.axes, split.max_log_scale)


def test_joint_matches_split_block_diagonal():
    d, n = 6, 2
    split = df.coupling_layer(d, [0, 2, 4], n=n, key=jax.random.key(0),
                              hidden_dim_s=16, hidden_dim_t=16,
                              zero_init_final=False)
    joint = _joint_from_split(split)
    x = jax.random.normal(jax.random.key(1), (64, d))
    th = jax.random.uniform(jax.random.key(2), (64, n))

    for direction in ("forward", "inverse"):
        ys, ls = getattr(split, direction)(x, th)
        yj, lj = getattr(joint, direction)(x, th)
        np.testing.assert_allclose(np.asarray(ys), np.asarray(yj),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ls), np.asarray(lj),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(split.forward_(x, th)),
                               np.asarray(joint.forward_(x, th)),
                               rtol=1e-6, atol=1e-6)

    # gradient parity: dNLL/dx identical through both parameterizations
    base = df.StandardNormal(d)

    def nll(layer, x):
        z, ldj = layer.inverse(x, th)
        return -jnp.mean(base.log_prob(z) + ldj)

    gs = jax.grad(nll, argnums=1)(split, x)
    gj = jax.grad(nll, argnums=1)(joint, x)
    np.testing.assert_allclose(np.asarray(gs), np.asarray(gj),
                               rtol=1e-5, atol=1e-6)


def test_joint_roundtrip_and_ldj_cancellation():
    d, n = 5, 1
    layer = df.coupling_layer(d, [0, 1, 2], n=n, key=jax.random.key(3),
                              joint_conditioner=True,
                              zero_init_final=False)
    assert isinstance(layer, df.JointRNVPCouplingLayer)
    x = jax.random.normal(jax.random.key(4), (32, d))
    th = jax.random.uniform(jax.random.key(5), (32, n))
    z, ldj_inv = layer.inverse(x, th)
    x2, ldj_fwd = layer.forward(z, th)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ldj_inv + ldj_fwd), 0.0, atol=1e-5)
    assert ldj_inv.dtype == jnp.float32


def test_joint_max_log_scale_clamps():
    d = 4
    layer = df.coupling_layer(d, 2, key=jax.random.key(6),
                              joint_conditioner=True, max_log_scale=2.0,
                              zero_init_final=False)
    x = 100.0 * jax.random.normal(jax.random.key(7), (16, d))  # OOD input
    z, ldj = layer.inverse(x, jnp.zeros((16, 0)))
    assert np.isfinite(np.asarray(z)).all()
    assert np.isfinite(np.asarray(ldj)).all()
    # ldj bounded by M·|af| per sample
    assert np.abs(np.asarray(ldj)).max() <= 2.0 * 2 + 1e-5


def test_joint_factory_validation():
    with pytest.raises(ValueError, match="must agree"):
        df.coupling_layer(4, 2, joint_conditioner=True,
                          hidden_dim_s=16, hidden_dim_t=32)
    with pytest.raises(ValueError, match="RNVP"):
        df.coupling_layer(4, 2, joint_conditioner=True,
                          kind=df.NICECouplingLayer)


def test_joint_trains_and_checkpoints(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 3)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(400, 1)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_block(data, None, key=jax.random.key(0),
                          joint_conditioner=True),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    df.train(flow, data, epochs=3, batchsize=64, verbose=False,
             key=jax.random.key(1), mixed_precision=True)
    assert np.isfinite(flow.train_loss).all()

    path = str(tmp_path / "joint_flow")
    df.save_flow(path, flow)
    restored = df.load_flow(path)
    xq = jnp.asarray(x[:16])
    np.testing.assert_allclose(
        np.asarray(flow.log_prob(xq, th[:16])),
        np.asarray(restored.log_prob(xq, th[:16])),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("dirn", ["fwd", "inv"])
def test_joint_fused_chain_matches_oracle(dirn):
    """The whole-chain kernel's ("coupling", "joint", …) op — shared
    stack + two folded heads — against the per-layer jnp fold
    (interpreter mode on CPU)."""
    from densityflows_tpu.models.fused_chain import (
        apply_fused, chain_is_fusable)

    d, n = 6, 2
    ks = jax.random.split(jax.random.key(0), 3)
    rng = np.random.default_rng(0)
    x_ref = rng.normal(size=(64, d)).astype(np.float32)
    chain = df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], n=n, key=ks[0],
                          joint_conditioner=True, zero_init_final=False),
        df.coupling_block(d, None, n=n, key=ks[1], joint_conditioner=True,
                          zero_init_final=False),
        # mix with a split layer + normalization to cover plan composition
        df.coupling_layer(d, [1, 3, 5], n=n, key=ks[2],
                          zero_init_final=False),
        df.normalization_layer(x_ref, -1.0, 1.0),
    )
    x = jax.random.normal(jax.random.key(5), (37, d)) * 0.5
    theta = jax.random.uniform(jax.random.key(6), (37, n))
    assert chain_is_fusable(chain, d), "joint chain should be fusable"
    out = apply_fused(chain, x, theta, dirn, True, interpret=True)
    ref = (chain.forward(x, theta) if dirn == "fwd"
           else chain.inverse(x, theta))
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref[0]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out[1]), np.asarray(ref[1]),
                               rtol=2e-5, atol=2e-5)
