"""Communication-pattern tests on the compiled sharded step.

Numeric equivalence tests can't see whether the partitioner lowered the
row-sharded table ops efficiently — a correctness-equivalent compilation
may all-gather a whole [rows, D] table or all-reduce a table-shaped
gradient. These tests compile the REAL hybrid train step on the virtual
8-device mesh at a table-dominant scale and assert byte-level properties
of the collectives:

1. no collective moves anything within 10x of a full table (the forward
   exchange and grad reductions must be batch-sized);
2. total collective bytes are INDEPENDENT of table row count — growing
   the tables 4x while holding the batch must not change the
   communication pattern at all (this also pins sparse-Adam moment
   updates as shard-local: moments are table-shaped, so any moment
   traffic would scale with rows).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ttamm.data import pack_positives
from ttamm.models import parse_model_config
from ttamm.parallel import (
    MeshConfig,
    build_mesh,
    make_sharded_train_step,
    pad_batch_data,
    pad_state_rows,
    place_data,
    place_state,
)
from ttamm.parallel.hlo_inspect import (
    assert_no_table_sized_collectives,
    collective_summary,
)
from ttamm.train import TrainStepConfig, create_train_state
from ttamm.train.optim import parse_dense_opt_config
from ttamm.train.state import BatchData

B, NEG, F, D = 64, 3, 16, 64


def _compiled_step_hlo(
    num_rows: int,
    *,
    sparse: bool = True,
    exchange: str = "gspmd",
    tensor_parallel: bool = False,
    comm_dtype: str = "float32",
    update_routing: str = "allgather",
    lowered_text: bool = False,
) -> str:
    """Compile the sharded hybrid step at [num_rows, D] tables; return HLO."""
    mc = {
        "user_encoder": {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": D, "sparse": sparse}},
            "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D},
            "fusion": "gated",
        },
        "item_encoder": {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": D, "sparse": sparse}},
            "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D},
            "fusion": "gated",
        },
        "similarity": "cosine",
        "adaptive_mimic": {"enabled": True},
    }
    cfg = parse_model_config(mc, user_feature_dim=F, item_feature_dim=F)
    state = create_train_state(
        jax.random.key(0), cfg, num_users=num_rows, num_items=num_rows
    )
    rng = np.random.default_rng(0)
    positives = {
        u: {int(x) for x in rng.integers(0, num_rows, 3)} for u in range(num_rows)
    }
    pp = pack_positives(positives, num_users=num_rows, num_items=num_rows)
    data = BatchData(
        user_features=jnp.asarray(
            rng.normal(0, 1, (num_rows, F)).astype(np.float32)
        ),
        item_features=jnp.asarray(
            rng.normal(0, 1, (num_rows, F)).astype(np.float32)
        ),
        positive_rows=jnp.asarray(pp.rows),
        category_ids=jnp.asarray(rng.integers(0, 4, num_rows).astype(np.int32)),
    )
    tscfg = TrainStepConfig(
        num_items=num_rows,
        negatives_per_positive=NEG,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        lambda_category_alignment=0.01,
        cal_max_categories=4,
        opt=parse_dense_opt_config(
            {"optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01}
        ),
        embedding_exchange=exchange,
        comm_dtype=comm_dtype,
        update_routing=update_routing,
    )
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    pstate = place_state(
        mesh, pad_state_rows(state, 4), tensor_parallel=tensor_parallel
    )
    pdata = place_data(mesh, pad_batch_data(data, 4))
    step = make_sharded_train_step(
        cfg, tscfg, mesh, pstate, pdata, tensor_parallel=tensor_parallel
    )
    u = jnp.asarray(rng.integers(0, num_rows, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, num_rows, B).astype(np.int32))
    lowered = step.lower(pstate, pdata, u, p, jax.random.key(1))
    if lowered_text:
        return lowered.as_text()
    return lowered.compile().as_text()


def test_no_table_sized_collectives():
    rows = 8192
    hlo = _compiled_step_hlo(rows)
    # All four tables are [rows(+pad), D]; the batch moves B*(1+NEG)*D
    # floats at most per exchange — 128x smaller. Anything within 10% of a
    # table means the partitioner fell back to gather/reduce-the-table.
    assert_no_table_sized_collectives(
        hlo,
        {
            "user_id": (rows, D),
            "item_id": (rows, D),
            "user_aug": (rows, D),
            "item_aug": (rows, D),
        },
        fraction=0.1,
    )


def test_collective_bytes_independent_of_table_rows():
    """Grow tables 4x at fixed batch: the collective footprint must not
    move by a single byte — communication is batch-shaped, and the
    table-shaped sparse-Adam moments never leave their shard."""
    small = collective_summary(_compiled_step_hlo(4096))
    large = collective_summary(_compiled_step_hlo(16384))
    assert small == large, (small, large)


def test_tensor_parallel_step_collectives_stay_batch_sized():
    """TP (Megatron col/row dense shardings + activation constraints) must
    add only batch-sized psums over the row layers — no table-sized
    collectives and no activation-grad replicate-repartition blowup (the
    round-2 lowering produced 3x the collectives and activation-sized
    all-gathers; the aligned weight/activation layouts eliminate it)."""
    rows = 8192
    tp_hlo = _compiled_step_hlo(rows, tensor_parallel=True)
    assert_no_table_sized_collectives(
        tp_hlo,
        {name: (rows, D) for name in
         ("user_id", "item_id", "user_aug", "item_aug")},
        fraction=0.1,
    )
    base_hlo = _compiled_step_hlo(rows)
    tp_bytes = sum(
        v["bytes"] for v in collective_summary(tp_hlo).values()
    )
    base_bytes = sum(
        v["bytes"] for v in collective_summary(base_hlo).values()
    )
    # The TP step's collective footprint stays within 10% of the pure-DP
    # step's (the row-layer psums are [B, D]-sized and replace, not add
    # to, the dense-grad reduction traffic for those weights).
    assert tp_bytes <= base_bytes * 1.10, (tp_bytes, base_bytes)


def test_alltoall_exchange_step_no_table_sized_collectives():
    """The explicit bucketed exchange path must also stay batch-sized."""
    rows = 8192
    hlo = _compiled_step_hlo(rows, exchange="alltoall")
    assert_no_table_sized_collectives(
        hlo,
        {name: (rows, D) for name in
         ("user_id", "item_id", "user_aug", "item_aug")},
        fraction=0.1,
    )
    small = collective_summary(_compiled_step_hlo(4096, exchange="alltoall"))
    large = collective_summary(_compiled_step_hlo(16384, exchange="alltoall"))
    assert small == large, (small, large)


def test_mesh_eval_no_corpus_sized_collectives():
    """The mesh eval sweep: with the corpus row-sharded and
    the shard-mapped distributed top-k, no collective may move anything
    near the [N, D] item-embedding slab — only [B, k]-sized local-winner
    merges cross links."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ttamm.evaluation.retrieval import _scan_encode_search_hits
    from ttamm.parallel.hlo_inspect import oversized_collectives

    rows = 4096  # users AND items (reuses the step helper's model shapes)
    mc = {
        "user_encoder": {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": D, "sparse": True}},
            "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D},
            "fusion": "gated",
        },
        "item_encoder": {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": D, "sparse": True}},
            "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D},
            "fusion": "gated",
        },
        "similarity": "cosine",
        "adaptive_mimic": {"enabled": True},
    }
    cfg = parse_model_config(mc, user_feature_dim=F, item_feature_dim=F)
    state = create_train_state(
        jax.random.key(0), cfg, num_users=rows, num_items=rows
    )
    rng = np.random.default_rng(0)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (rows, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (rows, F)).astype(np.float32)),
        positive_rows=jnp.asarray(
            rng.integers(0, rows, (rows, 4)).astype(np.int32)
        ),
        category_ids=jnp.asarray(rng.integers(0, 4, rows).astype(np.int32)),
    )
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    from ttamm.parallel import pad_batch_data, pad_state_rows, place_data, place_state

    pstate = place_state(mesh, pad_state_rows(state, 4))
    pdata = place_data(mesh, pad_batch_data(data, 4))
    items = jax.device_put(
        jnp.asarray(rng.normal(0, 1, (rows, D)).astype(np.float32)),
        NamedSharding(mesh, P("model", None)),
    )
    user_mat = jnp.asarray(rng.integers(0, rows, (2, B)).astype(np.int32))
    gt_mat = jnp.asarray(rng.integers(0, rows, (2, B, 3)).astype(np.int32))
    blocked = jnp.asarray(rng.integers(0, rows, (rows, 4)).astype(np.int32))

    lowered = _scan_encode_search_hits.lower(
        pstate, pdata, cfg, user_mat, gt_mat, items, blocked,
        deep_k=13, chunk=2048, cosine=True, max_k=10,
        mesh=mesh, num_valid_rows=rows,
    )
    hlo = lowered.compile().as_text()
    slab_bytes = rows * D * 4
    bad = oversized_collectives(hlo, slab_bytes // 10)
    assert not bad, [str(c) for c in bad]


def test_comm_bf16_emits_bf16_row_grad_allgathers():
    """comm_dtype='bfloat16' must put bf16 on the wire of the explicit
    shard_map exchange (the shard-local owner-routed sparse update).
    Pinned on the LOWERED program (our emission): the XLA:CPU backend
    widens bf16 collectives back to f32 during backend optimization
    (observed), while accelerator backends execute them natively — the
    compiled-text pin would test the CPU backend, not our code. The
    barrier in sharded_sparse_adam_update is load-bearing: without it XLA
    hoists the converts across the collective even at emission level."""
    rows = 8192
    low_f32 = _compiled_step_hlo(
        rows, update_routing="owner_unchecked", lowered_text=True
    )
    low_bf16 = _compiled_step_hlo(
        rows, comm_dtype="bfloat16", update_routing="owner_unchecked",
        lowered_text=True,
    )

    def bf16_gathers(txt):
        return sum(
            1
            for line in txt.splitlines()
            if "all_gather" in line and "bf16" in line
        )

    assert bf16_gathers(low_f32) == 0
    # user + item sparse-update grad gathers (dedup'd modules may fold
    # same-shape gathers; require at least one per distinct lane shape).
    assert bf16_gathers(low_bf16) >= 2, low_bf16.count("all_gather")


def test_owner_routing_shrinks_update_allgather_widths():
    """Owner routing: the sparse-update row-grad all-gathers must be
    emitted at the compacted CAPACITY width (~1/mp of the full batch),
    not the full lane width. Pinned on the LOWERED program like the
    comm_dtype test (emission is ours; backends may rewrite). On the 2x4
    mesh at B=64/NEG=3: item lanes are 256 global (128 local, capacity
    64), so the full allgather routing gathers [128,64]->[256,64] while
    owner routing gathers [64,64]->[128,64]. The safe 'owner' variant
    carries the overflow conditional (fallback branch = full-width
    gathers, executed only on capacity overflow); 'owner_unchecked' must
    not. Operand and result types share the MLIR line, so the checks key
    on the RESULT width marker."""
    rows = 4096

    def gather_lines(txt):
        return [l for l in txt.splitlines() if "all_gather" in l]

    low_unc = _compiled_step_hlo(
        rows, update_routing="owner_unchecked", lowered_text=True
    )
    low_own = _compiled_step_hlo(
        rows, update_routing="owner", lowered_text=True
    )

    # Unchecked owner: capacity-width gathers only ([64,64]->[128,64] for
    # items) — the full-width gather is GONE (no fallback branch).
    assert any("128x64" in l for l in gather_lines(low_unc))
    assert not any("256x64" in l for l in gather_lines(low_unc))

    # Safe owner: capacity-width gathers on the hot branch, and the
    # full-width gather still present — but only inside the overflow
    # conditional's fallback branch. (Presence of a conditional op is not
    # assertable directly: unrelated lowerings also emit stablehlo.case.)
    assert any("128x64" in l for l in gather_lines(low_own))
    assert any("256x64" in l for l in gather_lines(low_own))
