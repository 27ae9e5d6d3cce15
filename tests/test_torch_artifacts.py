"""The port's artifact zoo CLI (``cli/artifacts.py``) on artifacts that
``cli/export_model.py`` writes: ``list``, ``check --run``, and an artifact
whose device this machine lacks.

The twin and weights of ``test_torch_export.py``: a plain and a pyramid
artifact (``DATASET.imgSizes (24, 32)`` at 32x48), batch 2, float32 on the
CPU. The metadata keys and the calling convention match the JAX package's
``artifacts`` tool, with ``torch_version`` in place of ``jax_version``.
"""

import json

import pytest
import torch

from open_world_semantic_segmentation_tpu_torch.cli import artifacts
from open_world_semantic_segmentation_tpu_torch.core import export
# variables and model: test_torch_export.py's module fixtures
from test_torch_export import SIZE, cli_export, model, variables

PYRAMID_SIZES = "(24, 32)"          # DATASET.imgSizes of the pyramid export


@pytest.fixture(scope="module")
def zoo(tmp_path_factory, model):
    """A plain and a pyramid artifact of the twin, written by
    cli/export_model."""
    root = tmp_path_factory.mktemp("zoo")
    cli_export(root, model, "plain.owss")
    cli_export(root, model, "pyramid.owss", "--pyramid", "DATASET.imgSizes",
               PYRAMID_SIZES)
    return root


def test_cli_list_and_check(zoo, capsys):
    assert artifacts.main(["list", str(zoo)]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["pyramid"] for r in rows] == [False, True]
    for row in rows:
        assert row["platforms"] == ["cpu"] and row["quant"] == "off"
        assert row["method"] == "dissum" and row["full_size"] == list(SIZE)
        assert row["model"] == "resnet50dilated+ppm_deepsup_embedding"
        assert artifacts.validate_meta(row) == []
    assert rows[0]["input"] == [2, *SIZE, 3]
    assert rows[1]["input"] == [[2, 24, 40, 3], [2, 32, 48, 3]]
    assert artifacts.main(["check", str(zoo), "--run"]) == 0
    reports = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert all(r["valid"] and r["ran_on_zeros"] for r in reports)
    assert reports[0]["in_avals"] == ["float32[2, 32, 48, 3]"]
    assert reports[0]["out_avals"] == ["uint8[2, 32, 48]",
                                       "float16[2, 32, 48]"]
    assert len(reports[1]["in_avals"]) == 2


def test_check_flags_a_device_this_machine_lacks(tmp_path, zoo):
    if torch.cuda.is_available():
        pytest.skip("this machine has the artifact's device")
    meta = export.read_meta(str(zoo / "plain.owss"))
    path = str(tmp_path / "c.owss")
    with open(str(zoo / "plain.owss"), "rb") as f:
        f.read(len(export.MAGIC))
        f.readline()
        export.save_exported(path, f.read(), {**meta,
                                               "platforms": ["cuda"]})
    report = artifacts.check_artifact(path, run=True)
    assert not report["runs_here"] and "ran_on_zeros" not in report
    assert artifacts.main(["check", path]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_exported(path)
