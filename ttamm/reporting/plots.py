"""Headless loss-curve rendering.

Produces the reference's loss-curve artifact (``src/reporting/plots.py:15-68``
is the behavioral spec: Agg backend, one marker-line per series, dashed
grid, dpi-180 PNG, ``ValueError`` on an all-empty history) with the
rendering split into validate → draw → write stages so other report
figures can reuse the same scaffolding.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

_FIGSIZE = (8, 5)
_DPI = 180
_LINE_STYLE = {"marker": "o", "linestyle": "-"}
_GRID_STYLE = {"linestyle": "--", "linewidth": 0.5, "alpha": 0.7}


def _nonempty_series(
    history: Mapping[str, Sequence[float]],
) -> dict[str, Sequence[float]]:
    series = {label: vals for label, vals in history.items() if vals}
    if not series:
        raise ValueError("Loss history is empty; nothing to plot.")
    return series


def _pyplot():
    """matplotlib is an optional extra (``pip install .[plots]``), imported
    on first use; raises ModuleNotFoundError when it is not installed."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    return plt


def _write_figure(fig, output_path: Path) -> None:
    plt = _pyplot()
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(output_path, dpi=_DPI)
    plt.close(fig)


def save_loss_curves(
    loss_history: Mapping[str, Sequence[float]],
    *,
    output_path: Path | str,
    xlabel: str = "Epoch",
    ylabel: str = "BCE Loss",
    title: str = "Training / Validation / Test Loss",
) -> Path:
    """Render every non-empty series (epochs 1..N) into one PNG."""
    series = _nonempty_series(loss_history)

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=_FIGSIZE)
    try:
        for label, values in series.items():
            ax.plot(
                range(1, len(values) + 1), values, label=label, **_LINE_STYLE
            )
        ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
        ax.grid(True, **_GRID_STYLE)
        ax.legend()
    except Exception:
        plt.close(fig)
        raise

    output_path = Path(output_path)
    _write_figure(fig, output_path)
    return output_path
