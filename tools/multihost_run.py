#!/usr/bin/env python
"""REAL multi-process `jax.distributed` run of the multihost layer.

The tests run everything multi-device in one process on 8 virtual devices;
this tool runs `init_distributed` -> `make_pod_mesh` -> TP step ->
`HostShardedEngine` under an actual multi-controller `jax.distributed`
bootstrap, on one machine: TWO OS processes, each with 4 local virtual CPU devices, forming
an 8-device 2-"host" pod.

What each child executes (the same program, multi-controller):
  1. ``multihost.init_distributed`` — real coordination-service bootstrap
     (process_count() == 2, 8 global / 4 local devices)
  2. ``multihost.make_pod_mesh(model_parallel=2)`` — global (data=4,
     model=2) mesh; every model row stays inside one process (the
     fast-interconnect confinement invariant, asserted)
  3. a cross-process ``psum`` over the data axis — proves distributed
     collectives execute (the forward pass itself keeps all collectives
     inside a host BY DESIGN, so this is the explicit cross-host check)
  4. ``tp.make_tp_step`` decode over the GLOBAL pod mesh — the SPMD
     program of tests/test_tp.py executed by two controllers; each child
     checksums its addressable logits shards
  5. ``HostShardedEngine`` over the host-local submesh — continuous
     batching with host-local admission, run_to_completion

The parent computes the single-process reference logits and compares every
child's shard checksums against it (atol 5e-2, the tp test tolerance).

Usage:  python tools/multihost_run.py            # parent: spawn + verify
        (children are spawned internally with --proc N --port P)
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MODEL_PARALLEL = 2
N_LOCAL = 4                      # virtual devices per process
N_PROC = 2
SEED = 5
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


def child(proc_id: int, port: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", N_LOCAL)

    import numpy as np
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.parallel import multihost, tp
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.models import llama

    multihost.init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=N_PROC, process_id=proc_id)
    assert jax.process_count() == N_PROC, jax.process_count()
    assert len(jax.devices()) == N_PROC * N_LOCAL
    assert len(jax.local_devices()) == N_LOCAL

    # ---- pod mesh: model rows must stay inside one process ----
    mesh = multihost.make_pod_mesh(model_parallel=MODEL_PARALLEL)
    assert mesh.axis_names == ("data", "model")
    for row in mesh.devices:
        assert len({d.process_index for d in row}) == 1, (
            "model axis crossed a process boundary")

    # ---- explicit cross-process collective (the cross-host check) ----
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    xs = jax.make_array_from_callback(
        (mesh.shape["data"], 128), NamedSharding(mesh, P("data", None)),
        lambda idx: np.arange(128, dtype=np.float32)[None, :]
        * (1 + np.arange(mesh.shape["data"])[idx[0]])[:, None])
    total = jax.jit(shard_map(
        lambda x: jax.lax.psum(x, "data"), mesh=mesh,
        in_specs=P("data", None), out_specs=P()))(xs)
    want = np.arange(128, dtype=np.float32) * sum(
        range(1, mesh.shape["data"] + 1))
    got = np.asarray(total.addressable_shards[0].data)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)

    # ---- the TP decode step over the GLOBAL mesh (multi-controller) ----
    cfg = PRESETS["debug"]
    params = llama.init_weights(cfg, seed=SEED)

    def put(tree, spec_tree):
        def one(leaf, spec):
            arr = np.asarray(leaf)
            s = NamedSharding(mesh, spec)
            return jax.make_array_from_callback(
                arr.shape, s, lambda idx: arr[idx])
        return jax.tree.map(one, tree, spec_tree,
                            is_leaf=lambda x: isinstance(x, P))

    sparams = put(params, tp.param_specs(params))
    B = mesh.shape["data"]
    cache0 = llama.KVCache.create(cfg, B, 256)
    cache = put(cache0, tp.cache_specs())
    toks_np = np.tile(np.asarray(PROMPT, np.int32), (B, 1))
    toks = put(toks_np, P("data", None))

    pre = tp.make_tp_step(cfg, mesh, sparams, decode=False)
    logits, cache = pre(sparams, toks, cache)
    shard_sums = sorted(
        (s.index[0].start or 0,
         s.data.shape[0],
         float(np.asarray(s.data).astype(np.float64).sum()))
        for s in logits.addressable_shards)

    # ---- HostShardedEngine over the host-local submesh ----
    from jax.sharding import Mesh

    def make_local_engine(pid, pod_mesh):
        local = multihost.group_devices_by_process()[pid]
        lmesh = Mesh(
            np.array(local).reshape(len(local) // MODEL_PARALLEL,
                                    MODEL_PARALLEL),
            axis_names=("data", "model"))
        from ggml_cuda_experiments_tpu.models.engine import Engine
        return Engine(params, cfg, mesh=lmesh, max_batch=2,
                      max_seq_len=128)

    eng = multihost.HostShardedEngine(make_local_engine, mesh)
    rid = eng.add_request(PROMPT, max_new_tokens=4)
    done = eng.run_to_completion()
    assert len(done[rid]) == 4, done

    print(json.dumps({
        "proc": proc_id,
        "processes": jax.process_count(),
        "devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "shard_sums": shard_sums,
        "engine_tokens": [int(t) for t in done[rid]],
    }), flush=True)


def parent() -> int:
    # reference logits on a plain single-process CPU
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.models import llama

    cfg = PRESETS["debug"]
    params = llama.init_weights(cfg, seed=SEED)
    B = (N_PROC * N_LOCAL) // MODEL_PARALLEL
    toks = jnp.asarray(np.tile(np.asarray(PROMPT, np.int32), (B, 1)))
    cache = llama.KVCache.create(cfg, B, 256)
    want, _ = llama.prefill(params, cfg, toks, cache)
    want = np.asarray(want, np.float64)           # [B, V]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--proc", str(i), "--port", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(N_PROC)
    ]
    outs = []
    ok = True
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            print(f"proc {i}: TIMEOUT", flush=True)
            ok = False
        if p.returncode != 0:
            ok = False
            print(f"proc {i}: exit {p.returncode}\n--- stderr tail ---\n"
                  + "\n".join(err.splitlines()[-15:]), flush=True)
            continue
        rec = json.loads(out.splitlines()[-1])
        outs.append(rec)
        print(f"proc {i}: {rec['processes']} processes, "
              f"{rec['devices']} devices ({rec['local_devices']} local), "
              f"engine tokens {rec['engine_tokens']}", flush=True)

    if not ok or len(outs) != N_PROC:
        return 1

    # each child addresses its own data rows, vocab-split over the model
    # axis: the two model shards of a row group sum to the full rows of
    # the single-process reference
    ok_logits = True
    for rec in outs:
        totals: dict = {}
        for start, nrows, got_sum in rec["shard_sums"]:
            key = (start, nrows)
            totals[key] = totals.get(key, 0.0) + got_sum
        for (start, nrows), got in totals.items():
            ref = float(want[start:start + nrows].sum())
            if abs(got - ref) > 5e-2 * max(1.0, abs(ref)):
                print(f"logits mismatch at rows {start}:+{nrows}: "
                      f"{got} vs {ref}")
                ok_logits = False
    eng_match = outs[0]["engine_tokens"] == outs[1]["engine_tokens"]
    print(f"logits vs single-process reference: "
          f"{'OK' if ok_logits else 'MISMATCH'}; "
          f"host-local engines agree: {eng_match}", flush=True)
    return 0 if (ok_logits and eng_match) else 1


if __name__ == "__main__":
    if "--proc" in sys.argv:
        i = sys.argv.index("--proc")
        proc_id = int(sys.argv[i + 1])
        port = int(sys.argv[sys.argv.index("--port") + 1])
        child(proc_id, port)
    else:
        sys.exit(parent())
