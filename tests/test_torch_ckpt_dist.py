"""Checkpoints of strategies that span processes, on the CPU: a 2-process
gloo cluster (``tests/_torch_ckpt_child.py``, one run under one deadline
that kills every survivor) trains a ``tiny_resnet`` under ``ps``,
``mirrored`` and the Horovod workflow, saves at step 2, and resumes a
fresh trainer to step 4.

- the resumed run is bitwise the uninterrupted one, state and losses,
  under each; under ``multiworker``, ``BackupAndRestore``'s epoch save
  restores bitwise and ``ModelCheckpoint`` saves beside it;
- one save is world-size independent: rank 0 writes it, with each
  ps slice of optimizer state gathered whole and every per-parameter
  optimizer tensor's parameter recorded; the ps save restores into
  ``mirrored`` (bitwise the ps run, as ps's update is mirrored's) and
  into one process (whole tensors, then within ``2·lr·steps`` of the
  2-process run: Adam turns rounding noise into ±lr steps);
- the Horovod shim's final save is rank 0's alone.
"""

import json
import os

import pytest

from _torch_cluster import REPO, Cluster

N = 2


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ckpt_dist")
    Cluster(os.path.join(REPO, "tests", "_torch_ckpt_child.py"), N,
            str(work)).wait(timeout=240)
    return work, [json.loads((work / f"out_{r}.json").read_text())
                  for r in range(N)]


@pytest.mark.parametrize("name", ["ps", "mirrored", "hvd"])
def test_save_and_resume_is_bitwise(outs, name):
    for out in outs[1]:
        got = out[name]
        assert got["state_equal"] and got["loss_equal"], got
        assert got["steps"] == [4]  # the resumed run saves on at step 4
        assert got["loader"] == {"epoch": 0, "step_in_epoch": 2,
                                 "batches_consumed": 2}
        assert got["owners"] > 0


def test_multiworker_backup_and_model_checkpoint(outs):
    """Epoch saves under ``multiworker``: ``BackupAndRestore``'s after
    epoch 1 restores bitwise; ``ModelCheckpoint`` saves every epoch."""
    for out in outs[1]:
        got = out["multiworker"]
        assert got["state_equal"], got
        assert got["backup_steps"] == [2, 4] and got["epoch_steps"] == [4]


def test_rank_zero_writes_one_world_size_free_save(outs):
    work, _ = outs
    for name in ("ps", "mirrored", "hvd"):
        steps = sorted(p.name for p in (work / name).iterdir())
        assert steps == ["2"], steps  # no temporaries, one directory


def test_ps_save_restores_into_mirrored_and_one_process(outs):
    for out in outs[1]:
        assert out["ps_into_mirrored"]
        one = out["ps_into_one"]
        assert one["shapes_whole"] and one["state_equal"], one
        assert one["step"] == 4
        assert one["max_diff"] <= 2 * 1e-3 * 2, one


def test_hvd_final_save_is_rank_zero_alone(outs):
    work, (first, second) = outs
    path = work / f"ImageNet-tiny-{N}GPUs-reuse.npz"
    assert first["hvd_save"] == str(path) and second["hvd_save"] is None
    assert path.is_file()
