"""The port's tooling against the JAX package's: ``utils/bench_artifact.py``
(the same statistics, directions, comparisons, series gate and CLI
output on the same inputs, over the committed artifact series too) and
``utils/profiling.py`` on ``torch.profiler`` (the step timer's stats from
a fixed list of step times, the snapshot's keys, the memory stats' shape,
and the profiler callback's trace window)."""

import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

from pddl_tpu.utils import bench_artifact as jax_bench
from pddl_tpu.utils import profiling as jax_prof

from pddl_tpu_torch.utils import bench_artifact as port_bench
from pddl_tpu_torch.utils import profiling as port_prof

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = os.path.join(REPO, "artifacts", "gpt_bench")


def _series_paths():
    return sorted(glob.glob(os.path.join(SERIES, "r*.json")))


def _leaf_keys():
    keys = set()
    for path in _series_paths():
        for record in jax_bench.load_artifact(path):
            keys.update(jax_bench._numeric_leaves(record))
    return sorted(keys)


def test_metric_direction_matches_jax():
    keys = _leaf_keys() + ["ttft_reduction_x", "spread_pct", "n_requests",
                           "working_set_x", "failover_s", "tok_s", "x"]
    assert len(keys) > 100
    for key in keys:
        assert port_bench.metric_direction(key) == \
            jax_bench.metric_direction(key), key


@pytest.mark.parametrize("samples", [[1.0, 2.0, 3.0], [0.5, 0.25, 1.0, 4.0],
                                     [3.0, 3.0, 3.0], [1e-6, 2e-6, 5e-6, 1e-6,
                                                       7e-6]])
def test_median_spread_matches_jax(samples):
    assert port_bench.median_spread(samples) == \
        jax_bench.median_spread(samples)


def test_median_spread_refuses_short_lists_like_jax():
    for pkg in (port_bench, jax_bench):
        with pytest.raises(ValueError, match=">= 3 samples"):
            pkg.median_spread([1.0, 2.0])


def _record(**results):
    return {"metric": "online_serving_tokens_per_sec",
            "config": {"model": "gpt 4x256", "slots": 8},
            "results": results}


def test_compare_matches_jax():
    old = _record(tokens_per_s=1000.0, ttft_p99_s=0.10, spread_pct=2.0,
                  legs=[{"replicas": 2, "goodput": 5.0}, {"tok_s": 3.0}])
    news = [
        _record(tokens_per_s=960.0, ttft_p99_s=0.10, spread_pct=9.0,
                legs=[{"replicas": 2, "goodput": 5.0}, {"tok_s": 3.0}]),
        _record(tokens_per_s=900.0, ttft_p99_s=0.15,
                legs=[{"replicas": 2, "goodput": 4.0}]),
        _record(toks_per_s=1000.0, ttft_p99_s=0.05),
    ]
    for new in news:
        for threshold in (5.0, 20.0):
            assert port_bench.compare(old, new, threshold_pct=threshold) \
                == jax_bench.compare(old, new, threshold_pct=threshold)
    other = copy.deepcopy(old)
    other["config"]["slots"] = 16
    for pkg in (port_bench, jax_bench):
        with pytest.raises(ValueError, match="not comparable"):
            pkg.compare(old, other)


def test_check_series_matches_jax_on_the_committed_series(tmp_path):
    paths = _series_paths()
    assert paths
    assert port_bench.check_series(paths) == jax_bench.check_series(paths)
    (tmp_path / "r01_x.json").write_text(json.dumps(
        _record(tokens_per_s=1000.0)))
    (tmp_path / "r02_x.json").write_text(json.dumps(
        _record(tokens_per_s=850.0)))
    (tmp_path / "r03_x.json").write_text("not json")
    mine = sorted(glob.glob(str(tmp_path / "r*.json")))
    got = port_bench.check_series(mine, threshold_pct=10.0)
    assert got == jax_bench.check_series(mine, threshold_pct=10.0)
    assert got[0] == 1 and len(got[1]) == 1


def test_cli_matches_jax(tmp_path, capsys):
    (tmp_path / "r01_x.json").write_text(json.dumps(
        _record(tokens_per_s=1000.0)))
    (tmp_path / "r02_x.json").write_text(json.dumps(
        _record(tokens_per_s=850.0)))
    for argv in (["gate", str(tmp_path)],
                 ["gate", str(tmp_path), "--threshold-pct", "20"],
                 ["compare", str(tmp_path / "r01_x.json"),
                  str(tmp_path / "r02_x.json")],
                 ["gate", SERIES]):
        outs = []
        for pkg in (port_bench, jax_bench):
            code = pkg._main(argv)
            outs.append((code, capsys.readouterr()))
        assert outs[0] == outs[1], argv
    assert outs[0][0] == 0  # the committed series passes its gate


def test_timed_stats_and_provenance():
    made, synced = [], []
    stats = port_bench.timed_stats(lambda: made.append(0) or len(made),
                                   synced.append, n_repeats=4)
    assert synced == [1, 2, 3, 4]  # each call's result synchronized
    assert set(stats) == {"median_s", "spread_pct", "samples_s"}
    assert len(stats["samples_s"]) == 4
    prov = port_bench.provenance(4)
    assert set(prov) == set(jax_bench.provenance(4)) | {"device"}
    assert prov["n_repeats"] == 4
    # nvidia-smi's "name, power.limit" line, or None without the tool.
    assert prov["device"] is None or "," in prov["device"]


# --------------------------------------------------------------- profiling
STEP_TIMES = [0.5, 0.25, 0.125, 0.3, 0.31, 0.29, 0.7, 0.05, 0.2, 0.26, 0.9]


@pytest.mark.parametrize("batch", [None, 32])
def test_step_timer_stats_match_jax(batch):
    """The same stats from the same step times (per device: the JAX side
    counts 8 fake devices, the port one process)."""
    import jax

    port = port_prof.StepTimer(global_batch_size=batch, verbose=0)
    ref = jax_prof.StepTimer(global_batch_size=batch, verbose=0)
    assert port.snapshot() == ref.snapshot()  # before data: every key None
    port.step_times = list(STEP_TIMES)
    ref.step_times = list(STEP_TIMES)
    got, want = port.stats, ref.stats
    assert set(got) == set(want)
    per_chip = got.pop("images_per_sec_per_chip", None)
    want_per_chip = want.pop("images_per_sec_per_chip", None)
    assert got == want
    assert set(port.snapshot()) == set(ref.snapshot())
    if batch:
        assert per_chip == got["images_per_sec"]  # one process, one device
        assert want_per_chip * jax.device_count() == pytest.approx(
            want["images_per_sec"])


def _fit(callbacks, steps=5):
    from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
    from pddl_tpu_torch.models.resnet import tiny_resnet
    from pddl_tpu_torch.train.loop import Trainer

    tr = Trainer(tiny_resnet(num_classes=10, device="cpu"), device="cpu")
    ds = SyntheticImageClassification(batch_size=4, image_size=16,
                                      num_classes=10, seed=0)
    tr.fit(ds, epochs=1, steps_per_epoch=steps, verbose=0,
           callbacks=callbacks)
    return tr


def test_step_timer_skips_the_first_step():
    timer = port_prof.StepTimer(global_batch_size=4, verbose=0)
    _fit([timer], steps=5)
    stats = timer.stats
    assert stats["steps_timed"] == 4
    assert stats["step_time_p99_s"] >= stats["step_time_p50_s"] > 0
    assert timer.snapshot()["step_time_p99_s"] == stats["step_time_p99_s"]


def _trace_names(logdir):
    [path] = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profiler_records_its_window(tmp_path):
    """``start_step=1, num_steps=2`` over 5 steps: the trace holds the
    regions marked in steps 1 and 2 and none of steps 0, 3 and 4."""
    from pddl_tpu_torch.train.callbacks import LambdaCallback

    def mark(step, logs):
        with port_prof.trace("mark", step=step):
            torch.ones(4).sum()

    logdir = str(tmp_path / "prof")
    _fit([LambdaCallback(on_train_batch_end=mark),
          port_prof.Profiler(logdir, epoch=0, start_step=1, num_steps=2)])
    names = _trace_names(logdir)
    assert {"mark step 1", "mark step 2"} <= names
    assert not {"mark step 0", "mark step 3", "mark step 4"} & names


def test_capture_and_trace(tmp_path):
    logdir = str(tmp_path / "cap")
    with port_prof.capture(logdir):
        with port_prof.trace("region"):
            torch.ones(8).cumsum(0)
    assert "region" in _trace_names(logdir)


def test_device_memory_stats_shape():
    stats = port_prof.device_memory_stats()
    want = next(iter(jax_prof.device_memory_stats().values()))
    assert list(stats) == ["cpu"]  # this host has no card
    for v in stats.values():
        assert set(v) == set(want)
        assert set(v.values()) == {-1}
    assert np.all([isinstance(x, int) for x in stats["cpu"].values()])
