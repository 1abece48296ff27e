"""Worker for the 2-process jax.distributed test (not a pytest module).

Launched by ``tests/test_multiprocess.py`` as ``python multiprocess_worker.py
<process_id> <port> <ckpt_dir>``. Joins a 2-process x 4-virtual-CPU-device
cluster (8 global devices), places the padded train state across processes
with ``jax.make_array_from_process_local_data``, runs ONE sharded hybrid
train step on a 4x2 global mesh, and prints ``LOSS <value>``.

Then exercises the multi-host checkpoint path end to end: saves the
post-step state sharded (each process writes only its own shard file),
restores it into a freshly-initialised differently-seeded template, runs a
SECOND step from the restored state, and prints ``LOSS2 <value>`` — the
continuation loss must agree across processes and with a single-process
two-step run (tests/test_multiprocess.py).
"""

import os
import sys

pid, port = int(sys.argv[1]), sys.argv[2]
ckpt_dir = sys.argv[3] if len(sys.argv) > 3 else None
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = "2"
os.environ["JAX_PROCESS_ID"] = str(pid)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from test_parallel import _setup, U, I, B  # noqa: E402
from ttamm.parallel import (  # noqa: E402
    MeshConfig,
    build_mesh,
    make_sharded_train_step,
    maybe_initialize_distributed,
    pad_batch_data,
    pad_state_rows,
)
from ttamm.parallel.sharding import (  # noqa: E402
    batch_sharding,
    data_shardings,
    state_shardings,
)

assert maybe_initialize_distributed(True), "jax.distributed.initialize failed"
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4, len(jax.local_devices())

cfg, state, data, tscfg = _setup()
mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
pstate = pad_state_rows(state, 2)
pdata = pad_batch_data(data, 2)


def _from_full(sharding, x):
    # Every process holds the FULL host array; passing global_shape ==
    # local_data.shape makes each process contribute its addressable
    # slices of it (omitting global_shape would instead treat the array
    # as this process's chunk and double the global batch dimension).
    x = np.asarray(x)
    return jax.make_array_from_process_local_data(
        sharding, x, global_shape=x.shape
    )


def put(tree, shardings):
    return jax.tree.map(
        lambda x, s: _from_full(s, x),
        tree,
        shardings,
    )


pstate = put(pstate, state_shardings(mesh, pstate))
pdata = put(pdata, data_shardings(mesh, pdata))
rng = np.random.default_rng(1)
u = _from_full(batch_sharding(mesh), rng.integers(0, U, B).astype(np.int32))
p = _from_full(batch_sharding(mesh), rng.integers(0, I, B).astype(np.int32))
# Keys can't be device_put onto non-addressable devices; compute one
# globally instead.
key = jax.jit(
    lambda: jax.random.key(42), out_shardings=NamedSharding(mesh, P())
)()

step = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
state1, metrics = step(pstate, pdata, u, p, key)
print(f"LOSS {float(np.asarray(jax.device_get(metrics['loss']))):.6f}")

if ckpt_dir is not None:
    # Multi-host checkpoint round trip: save the post-step state (each
    # process writes its own shards), barrier, restore into a fresh
    # template, continue training — continuation must be exact.
    import jax.experimental.multihost_utils as mhu

    from ttamm.train import load_sharded_checkpoint, save_sharded_checkpoint

    path = save_sharded_checkpoint(
        ckpt_dir, state1, experiment_name="mp", epoch=1,
        metric_name="loss", metric_value=1.0,
    )
    mhu.sync_global_devices("ckpt_saved")  # all shard files on disk

    _, template, _, _ = _setup(seed=123)  # different values than state1
    template = put(
        pad_state_rows(template, 2),
        state_shardings(mesh, pad_state_rows(template, 2)),
    )
    restored, meta = load_sharded_checkpoint(path, template)
    assert int(meta["epoch"]) == 1

    u2 = _from_full(batch_sharding(mesh), rng.integers(0, U, B).astype(np.int32))
    p2 = _from_full(batch_sharding(mesh), rng.integers(0, I, B).astype(np.int32))
    key2 = jax.jit(
        lambda: jax.random.key(43), out_shardings=NamedSharding(mesh, P())
    )()
    _, metrics2 = step(restored, pdata, u2, p2, key2)
    print(f"LOSS2 {float(np.asarray(jax.device_get(metrics2['loss']))):.6f}")
