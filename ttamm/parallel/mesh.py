"""Device mesh construction and axis conventions.

The framework's scale-out model (SURVEY §2.3): a 2-D logical mesh

- ``data`` axis — batch (data parallelism): dense params replicated,
  gradients psum-reduced by XLA;
- ``model`` axis — embedding-table rows (model-parallel sharding): the
  user/item ID tables, mimic augmentation tables, feature matrices, and
  optimizer moments are row-sharded; lookups and sparse updates cross the
  axis via XLA-inserted collectives (all-gather of batch indices + masked
  local gather + psum), the standard DLRM embedding-sharding pattern.

The mesh is laid out in plain device order: the cards of one host are
joined all to all, so no axis is cheaper than another and the layout
follows the algorithm alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshConfig:
    data_parallel: int = 1
    model_parallel: int = 1

    @property
    def num_devices(self) -> int:
        return self.data_parallel * self.model_parallel


def parse_mesh_config(config: Mapping[str, Any] | None) -> MeshConfig:
    cfg = dict(config or {})
    return MeshConfig(
        data_parallel=int(cfg.get("data_parallel", 1)),
        model_parallel=int(cfg.get("model_parallel", 1)),
    )


def build_mesh(
    cfg: MeshConfig, devices: Sequence[jax.Device] | None = None
) -> Mesh:
    """Build the (data, model) mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    needed = cfg.num_devices
    if len(devices) < needed:
        raise ValueError(
            f"Mesh needs {needed} devices (data={cfg.data_parallel} x "
            f"model={cfg.model_parallel}) but only {len(devices)} available."
        )
    device_grid = np.asarray(devices[:needed]).reshape(
        cfg.data_parallel, cfg.model_parallel
    )
    return Mesh(device_grid, (DATA_AXIS, MODEL_AXIS))


def round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple
