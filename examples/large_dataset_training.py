"""Worked example: training at dataset scale, resident and streamed.

Trains a conditional flow on 60k rows twice: with ``df.train`` (the
whole dataset in device memory, one program for the run) and with
``df.train_streaming`` (batches assembled on the host from an array that
could be a memmap larger than device memory).

Run: python examples/large_dataset_training.py
"""

import numpy as np
import jax

import densityflows_tpu as df


def simulate(n, rng):
    theta = rng.uniform(-1.0, 2.0, size=(n, 1)).astype(np.float32)
    x1 = rng.normal(size=n)
    x2 = np.sin(x1 / 0.8) + 0.3 * rng.normal(size=n) + theta[:, 0]
    x3 = np.cos(x1 / 1.1) + 0.3 * rng.normal(size=n) - 0.2 * theta[:, 0]
    x = np.stack([x1, x2, x3], axis=1).astype(np.float32)
    return x, theta


def main():
    rng = np.random.default_rng(0)
    x, theta = simulate(60_000, rng)
    data = df.DataArrays.make(x, theta, rng=0)

    ks = jax.random.split(jax.random.key(0), 2)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1], hidden_dim_s=16, hidden_dim_t=16,
                          key=ks[0]),
        df.coupling_layer(data, [1, 2], hidden_dim_s=16, hidden_dim_t=16,
                          key=ks[1]),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    df.train(flow, data, df.adam(1e-3), epochs=3, batchsize=64,
             verbose=True, key=jax.random.key(1))
    print(f"resident: final valid NLL  = {flow.valid_loss[-1]:.3f}")

    streamed = df.Flow(chain, data)
    df.train_streaming(streamed, x, theta, epochs=3, batchsize=64,
                       verbose=True)
    print(f"streamed: final train NLL  = {streamed.train_loss[-1]:.3f}")

    s = flow.sample((10_000,), (0.5,), key=jax.random.key(2))
    print(f"10k conditional draws at theta=0.5: mean "
          f"{np.asarray(s).mean(0).round(3)}")


if __name__ == "__main__":
    main()
