#!/usr/bin/env python
"""Train a two-tower model from a YAML config (ref ``scripts/train.py``)."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def parse_args() -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train the two-tower model.")
    parser.add_argument(
        "--config",
        type=Path,
        default=REPO_ROOT / "configs" / "default.yaml",
        help="Path to the experiment YAML configuration.",
    )
    parser.add_argument(
        "--platform",
        type=str,
        default=None,
        help="Force a JAX platform (e.g. 'cpu' for hermetic runs).",
    )
    return parser.parse_args()


def main() -> None:
    args = parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from ttamm.pipelines import run_training
    from ttamm.utils import enable_persistent_cache, load_config

    # The persistent cache lets reruns (sweeps, resume, retries) skip
    # compilation.
    enable_persistent_cache()

    config = load_config(args.config)
    result = run_training(config)
    results = result if isinstance(result, list) else [result]
    for res in results:
        print(
            f"run={res.config.get('experiment', {}).get('name')} "
            f"best_metric={res.best_metric} best_epoch={res.best_epoch} "
            f"runtime_s={res.runtime_seconds:.1f} "
            f"examples_per_s={res.examples_per_second}"
        )


if __name__ == "__main__":
    main()
