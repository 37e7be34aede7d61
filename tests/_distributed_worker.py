"""Worker process for the 2-process ``jax.distributed`` DP tests.

Launched by tests/test_multihost.py (and by ``__graft_entry__.py``'s
multiprocess smoke): each of 2 processes gets 4 virtual CPU devices,
joins a shared coordination service, and runs the REAL multi-host path —
``train(mesh=...)`` assembling its per-host rows into globally-sharded
arrays via ``jax.make_array_from_process_local_data``
(parallel/mesh.py:global_batch_from_host_local), plus a checkpoint
save (process 0) / load (both) roundtrip across the process barrier.

Writes ``result_<pid>.json`` with the loss histories so the parent can
assert cross-process agreement and equality with a single-process run
on the same 8-device mesh.

usage: python _distributed_worker.py <pid> <port> <out_dir> [epochs]
"""

import json
import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    out_dir = sys.argv[3]
    epochs = int(sys.argv[4]) if len(sys.argv) > 4 else 3

    # 4 virtual CPU devices per process, BEFORE any backend use
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from densityflows_tpu.parallel.mesh import distributed_init, make_mesh

    distributed_init(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    assert jax.process_count() == 2
    assert jax.local_device_count() == 4 and jax.device_count() == 8

    import numpy as np
    import jax.numpy as jnp
    import optax

    import densityflows_tpu as df

    # identical dataset + flow construction on every host (deterministic)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    th = rng.uniform(0, 1, size=(512, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_block(data, None, key=jax.random.key(0),
                          hidden_dim_s=16, hidden_dim_t=16),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)
    mesh = make_mesh((8,), ("data",))

    optimizer = optax.adam(1e-3)
    opt_state = df.train(
        flow, data, optimizer, epochs=epochs, batchsize=64, mesh=mesh,
        key=jax.random.key(7), verbose=False,
    )
    assert np.isfinite(flow.train_loss).all()
    assert np.isfinite(flow.valid_loss).all()

    # checkpoint across the process barrier: host 0 writes, both load
    from jax.experimental import multihost_utils

    ckpt = os.path.join(out_dir, "ckpt")
    if pid == 0:
        df.save_flow(ckpt, flow, opt_state, erase=True)
    multihost_utils.sync_global_devices("densityflows:ckpt_written")
    restored, restored_opt = df.load_flow(ckpt, optimizer)
    lp_live = np.asarray(flow.log_prob(jnp.asarray(x[:8]), th[:8]))
    lp_ckpt = np.asarray(restored.log_prob(jnp.asarray(x[:8]), th[:8]))
    assert np.allclose(lp_live, lp_ckpt, atol=1e-6), (lp_live, lp_ckpt)
    assert restored_opt is not None

    # SHARDED checkpoint across processes: an array distributed over the
    # whole 8-device mesh is saved by Orbax (each process writes only its
    # shards) and restored to the same sharding — no host ever holds the
    # global array (utils/orbax_ckpt.py doctrine; VERDICT r2 item 1)
    import orbax.checkpoint as ocp

    from densityflows_tpu.parallel.mesh import data_sharding, put_global

    rows = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    sharded = put_global(mesh, rows)
    assert not sharded.is_fully_addressable  # genuinely distributed
    ckptr = ocp.StandardCheckpointer()
    opath = os.path.join(out_dir, "orbax_sharded")
    ckptr.save(opath, {"arr": sharded}, force=True)
    ckptr.wait_until_finished()
    restored_arr = ckptr.restore(
        opath,
        {"arr": jax.ShapeDtypeStruct((64, 4), np.float32,
                                     sharding=data_sharding(mesh, 2))},
    )["arr"]
    for db in restored_arr.addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(db.data), rows[db.index[0]]
        )
    multihost_utils.sync_global_devices("densityflows:orbax_done")

    # multi-host DP STREAMING: each host streams its own loader shard; the
    # global batch is assembled across processes and the gradient psum
    # rides the mesh (data_stream.train_streaming mesh path)
    sflow = df.Flow(chain, data)
    sflow.model = flow.model
    df.train_streaming(
        sflow, x, th, optimizer, epochs=1, batchsize=32, seed=5,
        verbose=False, mesh=mesh,
    )
    stream_loss = float(sflow.train_loss[-1])
    assert np.isfinite(stream_loss)

    # scaling_report under the multi-process rig: the full-job-mesh
    # branch (parallel/scaling.py:117-129) must EXECUTE across both
    # processes, and sub-mesh sweeps must be rejected (VERDICT r3 #8)
    from densityflows_tpu.parallel.scaling import scaling_report

    def make_model(key):
        return df.flow_chain(
            df.coupling_block(4, None, n=2, key=key, hidden_dim_s=8,
                              hidden_dim_t=8),
        )

    pts = scaling_report(make_model, 4, 2, per_device_batch=16,
                         device_counts=[8], reps=2)
    assert len(pts) == 1 and pts[0].n_devices == 8
    assert np.isfinite(pts[0].train_samples_per_sec)
    assert np.isfinite(pts[0].sample_draws_per_sec)
    scaling_sps = float(pts[0].train_samples_per_sec)
    try:
        scaling_report(make_model, 4, 2, per_device_batch=16,
                       device_counts=[4], reps=1)
        raise AssertionError("sub-mesh sweep must be rejected multi-process")
    except ValueError:
        pass

    with open(os.path.join(out_dir, f"result_{pid}.json"), "w") as f:
        json.dump(
            {
                "pid": pid,
                "train_loss": [float(v) for v in flow.train_loss],
                "valid_loss": [float(v) for v in flow.valid_loss],
                "ckpt_roundtrip_ok": True,
                "stream_loss": stream_loss,
                "scaling_train_sps": scaling_sps,
            },
            f,
        )


if __name__ == "__main__":
    main()
