"""Multi-host data-parallel training, runnable on one machine.

Demonstrates the REAL multi-host path — ``jax.distributed`` bootstrap,
per-host batch assembly through ``jax.make_array_from_process_local_data``
(no host ever holds the global array), the GSPMD-inserted gradient psum,
streaming DP, and a cross-process checkpoint — by spawning 2 local
processes with 4 virtual CPU devices each. On a multi-node GPU cluster the
ONLY changes are: drop the XLA_FLAGS virtual-device forcing, and let
``distributed_init()`` read the coordinator from the environment.

Run:  python examples/multihost_dp.py
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(pid: int, port: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import optax

    import densityflows_tpu as df
    from densityflows_tpu.parallel.mesh import distributed_init, make_mesh

    # 1. bootstrap: one coordinator, every host calls in
    distributed_init(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    print(f"[host {pid}] {jax.local_device_count()} local / "
          f"{jax.device_count()} global devices")

    # 2. identical flow + data construction on every host (deterministic);
    #    in production each host would np.load only its row shard
    #    (parallel.mesh.host_local_rows gives the slice)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4096, 8)).astype(np.float32)
    th = rng.uniform(0, 1, size=(4096, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_block(data, None, key=jax.random.key(0),
                          joint_conditioner=True),
        df.normalization_layer(x, -1.0, 1.0),
    )
    flow = df.Flow(chain, data)

    # 3. the global mesh spans both hosts' devices; train() assembles each
    #    host's rows into the globally-sharded batch and GSPMD inserts the
    #    gradient all-reduce. Same key on every host (the shuffle is part
    #    of the SPMD program).
    mesh = make_mesh((8,), ("data",))
    optimizer = optax.adam(1e-3)
    opt_state = df.train(flow, data, optimizer, epochs=5, batchsize=256,
                         mesh=mesh, key=jax.random.key(7),
                         verbose=(pid == 0))

    # 4. checkpoint across the process barrier: host 0 writes, all load
    from jax.experimental import multihost_utils

    ckpt = "/tmp/densityflows_multihost_example"
    if pid == 0:
        df.save_flow(ckpt, flow, opt_state, erase=True)
    multihost_utils.sync_global_devices("example:ckpt")
    restored = df.load_flow(ckpt)
    print(f"[host {pid}] final train NLL {flow.train_loss[-1]:.4f}, "
          f"checkpoint reload OK "
          f"({type(restored.model).__name__})")

    # 5. streaming DP: each host streams its own shard, psum over the mesh
    df.train_streaming(flow, x, th, optimizer, epochs=1, batchsize=128,
                       mesh=mesh, verbose=False)
    print(f"[host {pid}] streaming-DP epoch NLL {flow.train_loss[-1]:.4f}")


def main() -> None:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = {**os.environ, "JAX_PLATFORMS": "",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen([sys.executable, __file__, str(pid), port], env=env)
        for pid in range(2)
    ]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"worker exit codes: {codes}")
    print("multi-host DP example: OK")


if __name__ == "__main__":
    if len(sys.argv) == 3:
        worker(int(sys.argv[1]), sys.argv[2])
    else:
        main()
