"""Checkpointing: save/restore the full TrainState with resume support.

Capability parity with ``_save_checkpoint`` (ref ``training.py:150-182``)
plus an actual resume path (the reference saves model+optimizer state but
never loads it — SURVEY.md §5). Filename templating, best-only /
per-epoch / keep-last modes match the reference config surface
(``configs/default.yaml:84-88``).

Format: a single ``.npz`` holding every pytree leaf under its
tree-path-derived key, plus a JSON-encoded metadata entry (epoch, metric,
timestamp). Device arrays are pulled host-side at save; restore re-creates
the exact pytree structure from a template state (so restored arrays can be
re-sharded by the caller's pjit placement).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any

import jax
import numpy as np

from .state import TrainState


def state_to_host(state: Any) -> dict[str, np.ndarray]:
    """Pull the full state to host once (flattened, keyed by pytree path).

    Pass the result as ``host_arrays`` to several :func:`save_checkpoint`
    calls in the same epoch (best + last) so the ~1 GB device->host
    transfer happens once, not per file.
    """
    return _flatten_with_keys(state)


def _flatten_with_keys(tree: Any) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in leaves_with_paths:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def checkpoint_filename(
    template: str | None,
    *,
    experiment_name: str,
    metric_name: str | None,
    metric_value: float | None,
    epoch: int,
) -> str:
    """Reference-compatible filename templating (ref ``training.py:159-170``);
    ``@`` and ``/`` in metric names are sanitised identically."""
    safe_metric = (metric_name or "metric").replace("@", "at").replace("/", "_")
    filename_template = template or "{experiment}_{metric}_epoch{epoch}.pt"
    value = metric_value if metric_value is not None else 0.0
    return filename_template.format(
        experiment=experiment_name, metric=safe_metric, value=value, epoch=epoch
    )


def save_checkpoint(
    directory: Path | str,
    state: TrainState,
    *,
    experiment_name: str,
    epoch: int,
    metric_name: str | None,
    metric_value: float | None,
    template: str | None = None,
    host_arrays: dict[str, np.ndarray] | None = None,
) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    filename = checkpoint_filename(
        template,
        experiment_name=experiment_name,
        metric_name=metric_name,
        metric_value=metric_value,
        epoch=epoch,
    )
    path = directory / filename

    arrays = dict(host_arrays) if host_arrays is not None else _flatten_with_keys(state)
    meta = {
        "epoch": epoch,
        "metric_name": metric_name,
        "metric_value": metric_value,
        "timestamp": time.time(),
        "format_version": 1,
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as handle:
        np.savez(handle, **arrays)
    return path


class AsyncCheckpointer:
    """Overlap checkpoint I/O with the next epoch's device compute.

    The ~1 GB device->host state pull and
    the npz disk write run on a single background worker thread; the caller
    hands in a *device-side clone* of the state (so later train steps can
    donate the live state's buffers) plus the per-file save specs, and gets
    the final paths back immediately. One worker thread keeps writes to the
    same file (e.g. ``{experiment}_last.pt``) ordered across epochs.

    The reference has no analog (its ``torch.save`` at ``training.py:150-182``
    blocks the epoch loop); this is Parity+ alongside resume.

    ``sharded=True`` switches every save to the multi-host format
    (``sharded_checkpoint.py``): the worker pulls only this process's
    addressable shards and each job writes a checkpoint *directory* —
    required whenever the state lives on a multi-process mesh (the flat
    ``.npz`` pull needs fully-addressable arrays).
    """

    def __init__(self, *, sharded: bool = False) -> None:
        self._last: threading.Thread | None = None
        self._errors: list[BaseException] = []
        self._sharded = sharded

    def submit(self, state: Any, jobs: list[dict[str, Any]]) -> list[Path]:
        """Queue ``state`` (a device clone) for saving under each job spec.

        Returns the target paths immediately (filenames are deterministic).
        Each submit runs on its own non-daemon thread chained behind the
        previous one, so (a) same-file writes stay ordered across epochs and
        (b) queued saves still complete if the main thread raises — the
        interpreter waits for non-daemon threads, and each one terminates
        after its own job (no idle worker to hang on).
        """
        paths = [
            Path(job["directory"])
            / checkpoint_filename(
                job.get("template"),
                experiment_name=job["experiment_name"],
                metric_name=job.get("metric_name"),
                metric_value=job.get("metric_value"),
                epoch=job["epoch"],
            )
            for job in jobs
        ]
        # Kick off the device->host copies now so the worker's np.asarray
        # mostly finds the bytes already landed (best effort; not all
        # backends implement the async copy hint).
        try:
            jax.tree_util.tree_map(
                lambda a: a.copy_to_host_async()
                if hasattr(a, "copy_to_host_async")
                else None,
                state,
            )
        except Exception:
            pass

        prev = self._last
        errors = self._errors

        sharded = self._sharded

        def _work() -> None:
            if prev is not None:
                prev.join()
            try:
                if sharded:
                    from .sharded_checkpoint import (
                        save_sharded_checkpoint,
                        state_to_host_shards,
                    )

                    pieces = state_to_host_shards(state)
                    for job in jobs:
                        save_sharded_checkpoint(
                            host_pieces=pieces, state=None, **job
                        )
                else:
                    host = state_to_host(state)
                    for job in jobs:
                        save_checkpoint(host_arrays=host, state=None, **job)
            except BaseException as exc:  # surfaced by wait()
                errors.append(exc)

        thread = threading.Thread(
            target=_work, name="ttamm-ckpt-writer", daemon=False
        )
        thread.start()
        self._last = thread
        return paths

    def wait(self) -> None:
        """Drain pending saves; re-raise the first background failure."""
        if self._last is not None:
            self._last.join()
            self._last = None
        if self._errors:
            raise RuntimeError(
                "Async checkpoint save failed"
            ) from self._errors[0]


def _convert_moment_layout(key: str, blob: Any) -> np.ndarray | None:
    """Bridge sparse-Adam moment layouts across checkpoint/template mismatch.

    ``training.packed_moments`` changes the optimizer pytree leaves
    (separate ``m``/``v`` vs lane-concatenated ``mv``); the conversion is a
    pure relayout (``mv = [m | v]`` along lanes), so a checkpoint saved in
    either layout restores into the other bit-exactly.
    """
    parts = key.rsplit("/", 1)
    if len(parts) != 2:
        return None
    prefix, leaf_name = parts
    if leaf_name == "mv":
        m_key, v_key = f"{prefix}/m", f"{prefix}/v"
        if m_key in blob and v_key in blob:
            return np.concatenate([blob[m_key], blob[v_key]], axis=1)
    elif leaf_name in ("m", "v"):
        mv_key = f"{prefix}/mv"
        if mv_key in blob:
            mv = blob[mv_key]
            half = mv.shape[1] // 2
            return mv[:, :half] if leaf_name == "m" else mv[:, half:]
    return None


def _moment_layout_available(key: str, blob: Any) -> bool:
    """Cheap key-presence test for :func:`_convert_moment_layout` — no
    array is materialised (the conversion concatenates GB-scale moments
    at the flagship table sizes; availability must not pay that twice)."""
    parts = key.rsplit("/", 1)
    if len(parts) != 2:
        return False
    prefix, leaf_name = parts
    if leaf_name == "mv":
        return f"{prefix}/m" in blob and f"{prefix}/v" in blob
    if leaf_name in ("m", "v"):
        return f"{prefix}/mv" in blob
    return False


def load_checkpoint(
    path: Path | str, template_state: TrainState
) -> tuple[TrainState, dict[str, Any]]:
    """Restore a TrainState saved by :func:`save_checkpoint`.

    ``template_state`` supplies the pytree structure (build it with
    ``create_train_state`` from the same config); leaf values are replaced
    by the checkpoint's arrays, placed with the template leaf's sharding
    (so resuming under a mesh restores the row-sharded layout directly).
    Sparse-Adam moment layouts are converted automatically, so
    ``training.packed_moments`` may be toggled between save and resume
    (the packed layout is a pure lane relayout of the separate one — see
    :func:`_convert_moment_layout`).

    A directory path dispatches to the multi-host sharded format
    (``sharded_checkpoint.py``).
    """
    path = Path(path)
    if path.is_dir():
        from .sharded_checkpoint import load_sharded_checkpoint

        return load_sharded_checkpoint(path, template_state)
    with np.load(path, allow_pickle=False) as blob:
        meta = json.loads(bytes(blob["__meta__"]).decode("utf-8"))
        flat_template = _flatten_with_keys(template_state)
        missing = [
            k
            for k in flat_template
            if k not in blob and not _moment_layout_available(k, blob)
        ]
        if missing:
            raise ValueError(
                f"Checkpoint {path} is missing {len(missing)} leaves "
                f"(first: {missing[:3]}); was it saved with a different config?"
            )
        leaves_with_paths, treedef = jax.tree_util.tree_flatten_with_path(
            template_state
        )
        new_leaves = []
        for pth, leaf in leaves_with_paths:
            key = "/".join(
                str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                for p in pth
            )
            arr = blob[key] if key in blob else _convert_moment_layout(key, blob)
            if arr.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"Shape mismatch for '{key}': checkpoint {arr.shape} vs "
                    f"state {np.shape(leaf)}"
                )
            if isinstance(leaf, jax.Array) and hasattr(leaf, "sharding"):
                # Restore the template's placement (row-sharded tables under
                # a mesh, plain device arrays single-chip) instead of
                # leaving host numpy for the caller to re-place.
                arr = jax.device_put(arr, leaf.sharding)
            new_leaves.append(arr)
        state = jax.tree_util.tree_unflatten(treedef, new_leaves)
    return state, meta
