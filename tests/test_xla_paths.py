"""The XLA paths against plain numpy float64 references, plus the checks
that keep the program honest about its device: the compile-cache
directory, imports without optional packages, the serving backend choice,
the smoke script's refusal to run without a GPU, the bench's peak table
and the plain device-order mesh."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.numpy_reference import (
    category_alignment_reference,
    mips_scores,
    sparse_adam_reference,
    topk_mismatches,
)
from ttamm.ops import category_alignment_loss, init_sparse_adam, mips_topk
from ttamm.ops.sparse_adam import SparseAdamState, sparse_adam_update

REPO = Path(__file__).resolve().parents[1]


def _dup_ids(rng, rows, lanes, kind):
    if kind == "few":  # mostly distinct rows
        return rng.choice(rows, lanes, replace=False).astype(np.int32)
    pool = rng.choice(rows, max(lanes // 8, 2), replace=False)
    return pool[rng.zipf(1.3, lanes) % pool.size].astype(np.int32)


# ----------------------------------------------------- sharded sparse update
@pytest.mark.parametrize("dups", ["few", "duplicate_heavy"])
@pytest.mark.parametrize("routing", ["allgather", "owner", "owner_unchecked"])
def test_shard_local_sparse_update_matches_single_device(routing, dups):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ttamm.parallel import MeshConfig, build_mesh
    from ttamm.parallel.sparse_update import sharded_sparse_adam_update

    rng = np.random.default_rng(3)
    rows, dim, lanes = 64, 8, 32
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    table = jnp.asarray(rng.normal(size=(rows, dim)), jnp.float32)
    idx = jnp.asarray(_dup_ids(rng, rows, lanes, dups))
    grads = jnp.asarray(rng.normal(size=(lanes, dim)), jnp.float32)
    ref_t, ref_s = sparse_adam_update(
        table, init_sparse_adam(table), idx, grads, lr=1e-2, weight_decay=0.1
    )
    row = NamedSharding(mesh, P("model", None))
    t = jax.device_put(table, row)
    zeros = jax.device_put(jnp.zeros_like(table), row)
    state = SparseAdamState(m=zeros, v=zeros, step=jnp.zeros((), jnp.int32))
    # Capacity 4x the balanced share: the owner routings never overflow.
    got_t, got_s = jax.jit(
        lambda t, s, i, g: sharded_sparse_adam_update(
            mesh, t, s, i, g, lr=1e-2, weight_decay=0.1, routing=routing,
            capacity_factor=4.0,
        )
    )(t, state, idx, grads)
    assert np.allclose(np.asarray(got_t), np.asarray(ref_t), atol=1e-5)
    assert np.allclose(np.asarray(got_s.m), np.asarray(ref_s.m), atol=1e-6)
    assert np.allclose(np.asarray(got_s.v), np.asarray(ref_s.v), atol=1e-6)
    assert int(got_s.step) == 1


# ---------------------------------------------------------- sparse Adam
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("packed", [False, True])
def test_sparse_adam_matches_numpy_reference(packed, weight_decay):
    rng = np.random.default_rng(4)
    rows, dim, lanes, lr, step = 500, 16, 300, 1e-3, 3
    table = rng.normal(0, 0.02, (rows, dim)).astype(np.float32)
    m = rng.normal(0, 1e-3, (rows, dim)).astype(np.float32)
    v = rng.uniform(0, 1e-6, (rows, dim)).astype(np.float32)
    idx = _dup_ids(rng, rows, lanes, "duplicate_heavy")
    grads = rng.normal(0, 1e-2, (lanes, dim)).astype(np.float32)
    state = init_sparse_adam(jnp.asarray(table), packed=packed)
    if packed:
        state = state._replace(mv=jnp.concatenate([m, v], axis=1))
    else:
        state = state._replace(m=jnp.asarray(m), v=jnp.asarray(v))
    state = state._replace(step=jnp.asarray(step, jnp.int32))
    new_t, new_s = sparse_adam_update(
        jnp.asarray(table), state, jnp.asarray(idx), jnp.asarray(grads),
        lr=lr, weight_decay=weight_decay,
    )
    touched, w_ref, m_ref, v_ref = sparse_adam_reference(
        table, m, v, step, idx, grads, lr=lr, weight_decay=weight_decay
    )
    got_t = np.asarray(new_t)
    assert np.allclose(got_t[touched], w_ref, rtol=0, atol=1e-3 * lr)
    assert np.allclose(np.asarray(new_s.m)[touched], m_ref, rtol=0, atol=1e-7)
    assert np.allclose(np.asarray(new_s.v)[touched], v_ref, rtol=1e-5, atol=1e-12)
    untouched = np.setdiff1d(np.arange(rows), touched)
    assert np.array_equal(got_t[untouched], table[untouched])
    assert int(new_s.step) == step + 1


# --------------------------------------------------- category alignment
@pytest.mark.parametrize("dim", [32, 128])
@pytest.mark.parametrize("categories", [10, 16, 64])
def test_category_alignment_value_and_grad_match_numpy(categories, dim):
    rng = np.random.default_rng(categories + dim)
    n = 600
    cats = np.minimum(rng.zipf(1.5, n) - 1, categories + 5).astype(np.int32)
    x = rng.normal(0, 0.3, (n, dim)).astype(np.float32)
    ref_loss, ref_grad = category_alignment_reference(cats, x, categories)
    loss, grad = jax.value_and_grad(
        lambda e: category_alignment_loss(
            jnp.asarray(cats), e, max_categories=categories
        )
    )(jnp.asarray(x))
    assert ref_loss > 0
    assert float(loss) == pytest.approx(ref_loss, rel=1e-4)
    assert np.allclose(
        np.asarray(grad), ref_grad, atol=1e-4 * np.abs(ref_grad).max()
    )


# ---------------------------------------------------------------- top-k
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algorithm", ["group_exact", "chunked"])
def test_mips_topk_matches_numpy_brute_force(algorithm, score_dtype, masked):
    rng = np.random.default_rng(5)
    n, b, k = 1000, 12, 10
    items = rng.normal(0, 1, (n, 32)).astype(np.float32)
    queries = rng.normal(0, 1, (b, 32)).astype(np.float32)
    mask = rng.integers(0, n, (b, 6)).astype(np.int32) if masked else None
    if score_dtype == "bfloat16":
        # bf16 mode is exact w.r.t. bf16-rounded inputs, scored in f32.
        def rnd(a):
            return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

        ref_q, ref_x, tol = rnd(queries), rnd(items), 0.05
    else:
        ref_q, ref_x, tol = queries, items, 1e-5
    _, idx = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=k, algorithm=algorithm,
        chunk_size=256, score_dtype=score_dtype,
        mask_rows=None if mask is None else jnp.asarray(mask),
    )
    scores = mips_scores(ref_q, ref_x, mask)
    assert topk_mismatches(np.asarray(idx), scores, k, tol) == 0


# -------------------------------------------------------- compile cache
@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_directory(tmp_path, env_set):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "given")
    code = (
        "import jax; from ttamm.utils import enable_persistent_cache;"
        "d = enable_persistent_cache();"
        "print(d); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    want = str(tmp_path / "given") if env_set else str(REPO / ".jax_cache")
    assert out[-2:] == [want, want]
    if env_set:  # used as given: no backend subdirectory appended
        assert sorted(p.name for p in (tmp_path / "given").iterdir()) == []


# ------------------------------------------------ optional-package imports
@pytest.mark.parametrize(
    "package", ["models", "ops", "train", "parallel", "serve", "evaluation"]
)
def test_device_path_imports_without_optional_packages(package):
    code = (
        "import sys\n"
        "for name in ('pandas', 'yaml', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        f"import ttamm.{package}\n"
        "import ttamm.evaluation.retrieval\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------- serving backend
def test_flat_index_auto_raises_on_device_error(monkeypatch):
    import ttamm.serve.flat_index as fi

    rng = np.random.default_rng(6)
    idx = fi.build_flat_index(rng.normal(0, 1, (50, 8)).astype(np.float32))

    def broken(self, queries, k):
        raise RuntimeError("device search failed")

    monkeypatch.setattr(fi, "accelerator_attached", lambda: True)
    monkeypatch.setattr(fi.FlatIndex, "_device_search", broken)
    with pytest.raises(RuntimeError, match="device search failed"):
        idx.search(rng.normal(0, 1, (3, 8)).astype(np.float32), 5)


# ------------------------------------------------------------ chip smoke
@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:  # a directory holding the script and nothing else of the repo
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_config_keeps_default_model_and_training():
    from ttamm.utils import load_config

    sys.path.insert(0, str(REPO))
    import chip_smoke

    default = load_config(REPO / "configs" / "default.yaml")
    assert chip_smoke.MODEL == default["model"]
    trimmed = {"num_epochs"}
    assert {k: v for k, v in chip_smoke.TRAINING.items() if k not in trimmed} \
        == {k: v for k, v in default["training"].items() if k not in trimmed}


# ----------------------------------------------------------------- bench
@pytest.mark.parametrize(
    "kind", ["NVIDIA H200", "cpu", "NVIDIA A100-SXM4-80GB"]
)
def test_bench_peaks_raise_on_unknown_device_kind(kind):
    sys.path.insert(0, str(REPO))
    import bench

    assert bench.device_peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] > 0
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4), (1, 8)])
def test_plain_device_order_mesh(shape):
    from ttamm.parallel import MeshConfig, build_mesh

    dp, mp = shape
    devices = jax.devices()[: dp * mp]
    mesh = build_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), devices)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (dp, mp)
    assert [d.id for d in mesh.devices.flat] == [d.id for d in devices]



@pytest.mark.parametrize(
    "columns, itemsize, block",
    [(2_000_064, 4, 256), (2_000_064, 2, 512), (100_096, 4, 4096),
     (10**10, 4, 1)],
)
def test_default_query_block_is_a_power_of_two_within_budget(
    columns, itemsize, block
):
    from ttamm.ops.topk import _SCORES_BYTES_BUDGET, default_query_block

    qb = default_query_block(columns, itemsize)
    assert qb == block
    assert qb == 1 or qb * columns * itemsize <= _SCORES_BYTES_BUDGET


@pytest.mark.parametrize("budget_queries", [1, 3, 4, 16])
def test_group_exact_blocked_by_budget_matches_brute_force(
    monkeypatch, budget_queries
):
    import ttamm.ops.topk as topk

    rng = np.random.default_rng(7)
    n, b, k = 300, 11, 7  # 3 groups of 128 columns
    items = rng.normal(0, 1, (n, 16)).astype(np.float32)
    queries = rng.normal(0, 1, (b, 16)).astype(np.float32)
    mask = rng.integers(0, n, (b, 4)).astype(np.int32)
    monkeypatch.setattr(topk, "_SCORES_BYTES_BUDGET", budget_queries * 384 * 4)
    _, idx = topk._group_exact_topk(
        jnp.asarray(queries), jnp.asarray(items), k, jnp.asarray(mask), n
    )
    scores = mips_scores(queries, items, mask)
    assert topk_mismatches(np.asarray(idx), scores, k, 1e-5) == 0


# ------------------------------------------- chip smoke: step comparison
@pytest.mark.parametrize(
    "mutation",
    ["none", "gradient_noise", "dense_update_x1.01", "dense_one_element_sign",
     "no_dense_weight_decay", "untouched_table_row", "dense_moment_x1.2"],
)
def test_chip_smoke_step_comparison_catches_wrong_updates(mutation):
    import copy

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from ttamm.train import make_train_step

    lr, wd = chip_smoke.TRAINING["learning_rate"], chip_smoke.TRAINING["weight_decay"]
    cfg, tscfg, args = chip_smoke.step_inputs(
        np.random.default_rng(0), users=40, items=48, batch=8, features=12)
    new, _ = make_train_step(cfg, tscfg)(*args)
    old, cpu = jax.device_get(args[0]), jax.device_get(new)
    gpu = copy.deepcopy(cpu)
    tree = jax.tree_util.tree_map
    if mutation == "dense_update_x1.01":
        gpu = gpu._replace(dense=tree(
            lambda n, o: o + 1.01 * (n - o), cpu.dense, old.dense))
    elif mutation == "dense_one_element_sign":
        # The element with the largest gradient moves the wrong way.
        flat_n, treedef = jax.tree_util.tree_flatten(cpu.dense)
        flat_o = jax.tree_util.tree_leaves(old.dense)
        flat_m = jax.tree_util.tree_leaves(cpu.opt_dense.m["dense"])
        i = int(np.argmax([np.abs(m).max() for m in flat_m]))
        j = np.unravel_index(np.argmax(np.abs(flat_m[i])), flat_m[i].shape)
        leaf = np.array(flat_n[i])
        leaf[j] = 2 * flat_o[i][j] - leaf[j]
        flat_n[i] = leaf
        gpu = gpu._replace(dense=jax.tree_util.tree_unflatten(treedef, flat_n))
    elif mutation == "no_dense_weight_decay":
        gpu = gpu._replace(dense=tree(
            lambda n, o: n + lr * wd * o, cpu.dense, old.dense))
    elif mutation in ("gradient_noise", "untouched_table_row"):
        # Gradient noise on the touched rows (within the moment bound)
        # widens the per-element weight bounds; it must not widen them on
        # rows that no gradient reached.
        m = np.array(cpu.opt_sparse["user_id"].m)
        m *= 1.0 + 1e-3 * np.random.default_rng(1).standard_normal(m.shape)
        gpu = gpu._replace(opt_sparse={**cpu.opt_sparse, "user_id": (
            cpu.opt_sparse["user_id"]._replace(m=m))})
        if mutation == "untouched_table_row":
            touched = set(np.asarray(args[2]).tolist())
            row = next(r for r in range(40) if r not in touched)
            t = np.array(cpu.tables["user_id"])
            t[row] += 1e-3 * lr
            gpu = gpu._replace(tables={**cpu.tables, "user_id": t})
    elif mutation == "dense_moment_x1.2":
        gpu = gpu._replace(opt_dense=cpu.opt_dense._replace(
            m=tree(lambda m: 1.2 * m, cpu.opt_dense.m)))
    result = chip_smoke.compare_train_steps(old, gpu, cpu, lr)
    assert result["ok"] == (mutation in ("none", "gradient_noise")), result


# ------------------------------------------------- former package name
@pytest.mark.parametrize(
    "alias", sorted(p.parent.name for p in REPO.glob("ttamm_*/__init__.py"))
)
def test_former_package_name_aliases_the_same_modules(alias):
    code = (
        "import importlib, warnings\n"
        "with warnings.catch_warnings(record=True) as caught:\n"
        "    warnings.simplefilter('always')\n"
        f"    old = importlib.import_module('{alias}.pipelines.training')\n"
        f"    from {alias}.ops import mips_topk\n"
        "import ttamm.ops, ttamm.pipelines.training as new\n"
        "assert old is new and mips_topk is ttamm.ops.mips_topk\n"
        "assert new.__spec__.name == 'ttamm.pipelines.training'\n"
        "assert any(w.category is DeprecationWarning for w in caught)\n"
        f"print(importlib.import_module('{alias}').__name__)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == alias, out.stderr
