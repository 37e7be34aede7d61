"""Multi-host data parallelism, actually executed: 2 ``jax.distributed``
processes (4 virtual CPU devices each) run the DP training program
over a shared 8-device mesh, with per-host batch assembly through
``jax.make_array_from_process_local_data`` — the path a real multi-node
cluster uses (SURVEY.md §2.2 DP disposition). The reference is
single-process (src/DensityFlows.jl:29-35); this is the axis this
engine must exceed it on.

Asserts:
- both processes complete and agree on the loss histories exactly
  (SPMD determinism);
- the 2-process histories equal a SINGLE-process run of the same program
  on the same 8-device mesh (the multi-host path changes placement, not
  math);
- a checkpoint written by host 0 is loaded by both hosts across the
  process barrier and reproduces the live model (in-worker assert).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest

import densityflows_tpu as df

_WORKER = os.path.join(os.path.dirname(__file__), "_distributed_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(_WORKER)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(out_dir: str, epochs: int = 3, timeout: int = 300):
    port = _free_port()
    env = {**os.environ, "JAX_PLATFORMS": "",
           "PYTHONPATH": _REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(port), out_dir,
             str(epochs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_REPO,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outputs.append(out)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    results = []
    for pid in range(2):
        with open(os.path.join(out_dir, f"result_{pid}.json")) as f:
            results.append(json.load(f))
    return results


def _single_process_reference(epochs: int = 3):
    """The same run on this process's own 8 virtual devices."""
    from densityflows_tpu.parallel.mesh import make_mesh

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
    import optax

    df.train(flow, data, optax.adam(1e-3), epochs=epochs, batchsize=64,
             mesh=make_mesh((8,), ("data",)), key=jax.random.key(7),
             verbose=False)
    return flow


@pytest.mark.skipif(jax.device_count() < 8,
                    reason="needs the 8-virtual-device CPU rig")
def test_two_process_dp_matches_single_process(tmp_path):
    epochs = 3
    results = _run_pair(str(tmp_path), epochs=epochs)

    # both hosts ran the same SPMD program → identical histories
    assert results[0]["train_loss"] == results[1]["train_loss"]
    assert results[0]["valid_loss"] == results[1]["valid_loss"]
    assert all(r["ckpt_roundtrip_ok"] for r in results)
    assert len(results[0]["train_loss"]) == epochs
    # streaming DP: the in-program psum makes the global loss identical
    # on both hosts
    assert results[0]["stream_loss"] == results[1]["stream_loss"]
    assert np.isfinite(results[0]["stream_loss"])
    # scaling_report's full-job-mesh branch executed on both processes
    assert results[0]["scaling_train_sps"] > 0
    assert results[1]["scaling_train_sps"] > 0

    ref = _single_process_reference(epochs=epochs)
    np.testing.assert_allclose(
        np.asarray(results[0]["train_loss"]), np.asarray(ref.train_loss),
        rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(results[0]["valid_loss"]), np.asarray(ref.valid_loss),
        rtol=0, atol=1e-5,
    )


def test_host_local_rows_contiguity():
    """Single-process: every row of a padded batch is covered exactly once
    by the per-process slices the multi-host path would use."""
    from densityflows_tpu.parallel.mesh import host_local_rows, make_mesh

    mesh = make_mesh((8,), ("data",))
    s = host_local_rows(mesh, 64)
    # single process owns everything
    assert (s.start, s.stop) == (0, 64)
