"""Multi-host pod execution: host-aware meshes and cross-host serving.

BASELINE.json config 5: 70B-class models tensor-sharded over NVLink within each
host and scaled across hosts over the network. The reference has nothing remotely
comparable (its only multi-device code is single-process,
/root/reference/src/misc/simpleMultiGPU.cu); this module provides the
structure:

- ``init_distributed``      jax.distributed bootstrap (one process per host)
- ``make_pod_mesh``         (data, model) mesh with ``model`` confined to
                            each host's NVLink-joined cards and ``data``
                            spanning hosts — so the per-token psums of
                            tensor parallelism never leave a host,
                            and the only inter-host traffic is batch
                            dispatch (scaling-efficiency critical, see
                            SURVEY §5 "distributed communication backend")
- ``HostShardedEngine``     continuous batching across hosts: each host
                            schedules its own slice of the global batch
                            (admission is host-local, so no cross-host
                            scheduler synchronization is on the token path)

Validation: process-placement logic is unit-tested with mock device lists
(tests/test_multihost.py), and the whole layer EXECUTES under a real
2-process ``jax.distributed`` bootstrap on every test run
(tests/test_multihost.py::test_real_two_process_distributed_run ->
tools/multihost_run.py): two OS processes x 4 virtual CPU devices form an
8-device pod, run init_distributed -> make_pod_mesh -> a cross-process
psum -> the global-mesh TP step (shard checksums vs the single-process
reference) -> HostShardedEngine end-to-end. The single-process 8-device
tests (tests/test_tp.py) cover the same SPMD program at full shape
coverage.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host pod run (no-op when
    single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def group_devices_by_process(devices=None) -> dict[int, list]:
    """Stable process_index -> devices map (one fast-interconnect domain per host)."""
    devices = list(devices if devices is not None else jax.devices())
    groups: dict[int, list] = {}
    for d in devices:
        groups.setdefault(d.process_index, []).append(d)
    return dict(sorted(groups.items()))


def make_pod_mesh(model_parallel: int | None = None, devices=None) -> Mesh:
    """(data, model) mesh with the model axis inside each host.

    ``model_parallel`` defaults to all chips of one host (full intra-host
    tensor parallelism). The data axis enumerates (host, chip-group) pairs,
    so data-parallel traffic — none during a forward pass — is the only
    thing that would cross hosts.
    """
    groups = group_devices_by_process(devices)
    per_host = {p: len(ds) for p, ds in groups.items()}
    n_local = min(per_host.values())
    assert min(per_host.values()) == max(per_host.values()), (
        f"uneven chips per host: {per_host}")
    if model_parallel is None:
        model_parallel = n_local
    assert n_local % model_parallel == 0, (
        f"model_parallel {model_parallel} must divide chips/host {n_local}")

    rows = []
    for p, ds in groups.items():
        for g in range(n_local // model_parallel):
            rows.append(ds[g * model_parallel:(g + 1) * model_parallel])
    arr = np.array(rows)                       # [data, model]
    return Mesh(arr, axis_names=("data", "model"))


class HostShardedEngine:
    """Continuous batching across hosts: one local Engine per host over the
    host's model-parallel group, batches independent per host.

    The global serving capacity is the union of per-host batches; because
    admission/eviction is host-local, no scheduler synchronization sits on
    the decode path (the 80%-scaling-efficiency requirement is then purely
    about weight/Kv sharding, which ``make_pod_mesh`` keeps inside a host).

    This class wires the pieces; on a real pod each process constructs it
    with the same arguments and serves its own request stream (a front-end
    load balancer distributes requests to hosts).
    """

    def __init__(self, make_local_engine, mesh: Mesh):
        self.mesh = mesh
        self.process_id = jax.process_index()
        self.engine = make_local_engine(self.process_id, mesh)

    def add_request(self, prompt, **kw):
        return self.engine.add_request(prompt, **kw)

    def step(self):
        return self.engine.step()

    def run_to_completion(self, **kw):
        return self.engine.run_to_completion(**kw)
