"""Device mesh construction and axis conventions.

Axes:
- ``data``:  batch (data parallelism). No collectives in the forward pass.
- ``model``: tensor parallelism — attention heads / MLP intermediate
  sharded ("Megatron"-style column/row parallel); one psum per block.

On real hardware the mesh should map ``model`` to the cards of one host
(the per-token collectives ride NVLink, which joins a host's cards all to
all) and ``data`` across hosts; multi-host layouts can pass an explicit
device array.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(model: int = 1, data: int | None = None,
              devices=None) -> Mesh:
    """Build a (data, model) mesh from the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        assert len(devices) % model == 0, (
            f"{len(devices)} devices not divisible by model={model}")
        data = len(devices) // model
    n = data * model
    assert n <= len(devices), f"need {n} devices, have {len(devices)}"
    arr = np.array(devices[:n]).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))
