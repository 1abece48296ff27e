from pathlib import Path

import pytest

from ttamm.utils import (
    clone_config,
    expand_grid,
    get_by_dotted_path,
    load_config,
    set_by_dotted_path,
)


def test_load_config_roundtrip(tmp_path: Path):
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(
        "training:\n  learning_rate: 0.001\n  batch_size: 32\n", encoding="utf-8"
    )
    cfg = load_config(cfg_file)
    assert cfg["training"]["learning_rate"] == 0.001
    assert cfg["training"]["batch_size"] == 32


def test_load_config_missing_file(tmp_path: Path):
    with pytest.raises(FileNotFoundError):
        load_config(tmp_path / "missing.yaml")


def test_clone_and_dotted_path():
    cfg = {"training": {"learning_rate": 0.001}}
    clone = clone_config(cfg)
    set_by_dotted_path(clone, "training.learning_rate", 0.01)
    set_by_dotted_path(clone, "model.new.key", 5)
    assert cfg["training"]["learning_rate"] == 0.001
    assert clone["training"]["learning_rate"] == 0.01
    assert clone["model"]["new"]["key"] == 5
    assert get_by_dotted_path(clone, "model.new.key") == 5
    assert get_by_dotted_path(clone, "model.absent", "default") == "default"


def test_expand_grid_names_and_overrides():
    cfg = {"experiment": {"name": "base"}, "training": {"lr": 1}}
    grid = {"training.lr": [1, 2], "training.bs": [8]}
    runs = list(expand_grid(cfg, grid))
    assert len(runs) == 2
    names = [r[0]["experiment"]["name"] for r in runs]
    assert names == ["base_sweep00", "base_sweep01"]
    assert runs[1][1] == {"training.lr": 2, "training.bs": 8}
    assert runs[1][0]["training"]["lr"] == 2


@pytest.mark.parametrize("key", ["use_pallas", "cal_use_pallas"])
def test_removed_kernel_switch_fails_clearly(tmp_path: Path, key: str):
    from ttamm.pipelines import run_training

    cfg = {"data": {"root": str(tmp_path / "absent")}, "training": {key: True}}
    with pytest.raises(ValueError, match=f"training.{key} is no longer a setting"):
        run_training(cfg)
