"""The trainer's fault boundary, checkpoints, preemption and resume
(`pddl_tpu_torch/train/faults.py`, `train/loop.py`, `ckpt/checkpoint.py`,
`utils/preemption.py`) on the CPU, held against the uninterrupted run
bit for bit and against the JAX package where the two must agree.

Every scenario trains a tiny Llama with adam, an EMA and 2-step gradient
accumulation (so a save carries moments, the accumulator mid-window, the
shadows and the step counter) for 3 epochs of 4 steps, and ends with
every leaf of `Trainer.state_dict()` — parameters, optimizer state, EMA,
step — bitwise equal to the clean run's (compared by their CRC32s):

- a seeded plan injects at the same (step, site, kind) coordinates as the
  JAX `TrainFaultPlan` does under the JAX trainer, and `fault_snapshot()`
  has the JAX trainer's keys;
- transients within the budget retry in place (tracer events at the
  plan's coordinates); spent retries restore the newest verified save and
  replay; an OOM goes straight to the restore; spent retries with no
  save to restore raise `TrainStateLost`; a latency fault only delays;
  an eval transient retries and its exhaustion raises the error;
- a kill (`KillPoint`) mid-epoch, then a new trainer's
  `fit(resume=dir)`, with the stream repositioned by `with_offset`, by a
  host-side skip within an epoch, and by a skip that re-iterates a
  finite dataset; an empty directory starts fresh;
- a torn newest save (truncated state) and a tampered one (a checksum in
  its metadata) are skipped on restore, and an explicit step raises;
  `CheckpointEveryN` keeps `max_to_keep` verified saves and refuses fewer
  than 2; `ModelCheckpoint(save_best_only)`, `BackupAndRestore`,
  `latest_epoch` and `initial_epoch` resume by epoch;
- SIGTERM under `PreemptionCheckpoint` saves at the next batch boundary
  and stops, its own or through a `CheckpointEveryN` delegate, and the
  resumed run is bitwise the clean one; the previous signal handlers come
  back even when `fit` raises;
- `save_params_npz` writes every tensor (bf16 widened to f32).
"""

import json
import os
import pathlib
import signal
import tempfile

import jax
import numpy as np
import pytest
import torch

from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.train.faults import TrainFaultPlan as JaxTrainFaultPlan
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.ckpt import (
    BackupAndRestore,
    CheckpointCorruptError,
    CheckpointEveryN,
    Checkpointer,
    ModelCheckpoint,
    latest_epoch,
    save_params_npz,
    tree_checksums,
)
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.obs import RequestTracer
from pddl_tpu_torch.train.callbacks import Callback
from pddl_tpu_torch.train.faults import (
    FaultKind,
    FaultSpec,
    InjectedTransientError,
    KillPoint,
    TrainFaultPlan,
    TrainStateLost,
)
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.utils.preemption import PreemptionCheckpoint

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VOCAB = 64
LM = dict(batch_size=4, seq_len=16, vocab_size=VOCAB, seed=3)
KEYS = dict(input_key="tokens", target_key="targets")
EPOCHS, SPE = 3, 4


def _data():
    return SyntheticLanguageModeling(**LM)


def _trainer(**kw):
    kw.setdefault("retry_sleep", lambda s: None)  # no wall-clock waits
    return Trainer(tiny_llama(vocab_size=VOCAB, max_len=32, device="cpu"),
                   optimizer="adam", learning_rate=1e-2, ema_decay=0.9,
                   gradient_accumulation_steps=2, device="cpu", seed=0,
                   **KEYS, **kw)


def _fit(tr, data=None, **kw):
    kw.setdefault("epochs", EPOCHS)
    kw.setdefault("steps_per_epoch", SPE)
    return tr.fit(_data() if data is None else data, verbose=0, **kw)


def _ckpt_cb(directory, every=3, **kw):
    return CheckpointEveryN(str(directory), every_n_steps=every,
                            async_save=False, **kw)


@pytest.fixture
def tmp_path():
    """Checkpoints go to a temporary directory removed after each test."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


@pytest.fixture(scope="module")
def clean():
    tr = _trainer()
    _fit(tr)
    return tree_checksums(tr.state_dict())


def _assert_bitwise(tr, clean):
    got = tree_checksums(tr.state_dict())
    assert got.keys() == clean.keys()
    bad = [k for k in got if got[k] != clean[k]]
    assert not bad, bad[:5]


def _newest(directory):
    return max(int(n) for n in os.listdir(directory) if n.isdigit())


# ---------------------------------------------------- against the JAX one
def test_seeded_plan_injects_where_the_jax_trainer_does():
    """The same seeded plan over the same call sequence fires at the same
    coordinates in both trainers (one rate draw per check)."""
    kw = dict(seed=5, transient_rate=0.3, max_random_injections=5)
    jplan, plan = JaxTrainFaultPlan(**kw), TrainFaultPlan(**kw)
    fired = {"jax": [], "port": []}
    jplan.on_inject = lambda s, site, k: fired["jax"].append((s, site, k))
    plan.on_inject = lambda s, site, k: fired["port"].append((s, site, k))
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=32)
    jtr = JaxTrainer(jm, optimizer="sgd", learning_rate=0.1, seed=0,
                     fault_plan=jplan, retry_sleep=lambda s: None, **KEYS)
    jtr.init_state(JaxLM(**LM).batch(0))
    tm = tiny_llama(vocab_size=VOCAB, max_len=32, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    tr = Trainer(tm, optimizer="sgd", learning_rate=0.1, seed=0,
                 fault_plan=plan, retry_sleep=lambda s: None, device="cpu",
                 **KEYS)
    jh = jtr.fit(JaxLM(**LM), epochs=2, steps_per_epoch=3, verbose=0,
                 validation_data=JaxLM(**{**LM, "seed": 9}),
                 validation_steps=1)
    th = tr.fit(_data(), epochs=2, steps_per_epoch=3, verbose=0,
                validation_data=SyntheticLanguageModeling(
                    **{**LM, "seed": 9}), validation_steps=1)
    assert fired["port"] == fired["jax"] and fired["port"]
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-5)
    snap, jsnap = tr.fault_snapshot(), jtr.fault_snapshot()
    assert snap.keys() == jsnap.keys()
    for key in ("retries", "recoveries", "faults_injected", "opt_step"):
        assert snap[key] == jsnap[key], key


def test_fault_plan_validates_sites():
    assert TrainFaultPlan.SITES == JaxTrainFaultPlan.SITES
    with pytest.raises(ValueError, match="unknown scheduled site"):
        TrainFaultPlan(scheduled=[FaultSpec(0, "tick", FaultKind.KILL)])


# ---------------------------------------------------- in-process recovery
def test_transient_within_budget_retries_in_place(clean):
    plan = TrainFaultPlan(scheduled=[
        FaultSpec(3, "train_step", FaultKind.TRANSIENT, count=2)])
    tracer = RequestTracer()
    tr = _trainer(fault_plan=plan, tracer=tracer)
    _fit(tr)
    _assert_bitwise(tr, clean)
    assert tr.fault_stats["retries"] == 2
    assert tr.fault_stats["recoveries"] == 0
    inj = tracer.events_named("fault_injected")
    assert [(e["step"], e["site"]) for e in inj] == [(3, "train_step")] * 2
    ret = tracer.events_named("retry")
    assert [(e["step"], e["site"], e["attempt"]) for e in ret] == \
        [(3, "train_step", 1), (3, "train_step", 2)]


@pytest.mark.parametrize("kind,count", [("transient", 4), ("oom", 1)])
def test_lost_state_restores_and_replays(tmp_path, clean, kind, count):
    """Step 7 fails past the budget (or by an OOM): the newest save (step
    6, mid accumulation window) is restored and step 6 replayed."""
    plan = TrainFaultPlan(scheduled=[
        FaultSpec(7, "train_step", FaultKind(kind), count=count)])
    tracer = RequestTracer()
    tr = _trainer(fault_plan=plan, tracer=tracer)
    _fit(tr, callbacks=[_ckpt_cb(tmp_path)])
    _assert_bitwise(tr, clean)
    assert tr.fault_stats["recoveries"] == 1
    assert tr.fault_stats["replayed_steps"] == 1
    assert tr.fault_stats["retries"] == (3 if kind == "transient" else 0)
    assert [(e["step"], e["restored_step"])
            for e in tracer.events_named("restore")] == [(7, 6)]
    assert tracer.events_named("recovery")[0]["replayed"] == 1


def test_torn_newest_save_replays_from_the_previous(tmp_path, clean):
    """Saves at 3 and 6; step 6's file is torn before step 7 fails: the
    restore falls back to step 3 and replays 3 to 6 (the buffer holds two
    intervals)."""
    class Tear(Callback):
        def on_train_batch_end(self, step, logs):
            if self.trainer.step == 6:
                path = tmp_path / "6" / "state.pt"
                path.write_bytes(path.read_bytes()[:1000])

    plan = TrainFaultPlan(scheduled=[
        FaultSpec(7, "train_step", FaultKind.OOM)])
    tr = _trainer(fault_plan=plan)
    _fit(tr, callbacks=[_ckpt_cb(tmp_path), Tear()])
    _assert_bitwise(tr, clean)
    assert tr.fault_stats["replayed_steps"] == 4


def test_spent_retries_without_a_save_raise():
    plan = TrainFaultPlan(scheduled=[
        FaultSpec(1, "train_step", FaultKind.TRANSIENT, count=5)])
    tr = _trainer(fault_plan=plan)
    with pytest.raises(TrainStateLost) as info:
        _fit(tr)
    assert isinstance(info.value.err, InjectedTransientError)


def test_latency_fault_delays_but_completes(clean):
    slept = []
    plan = TrainFaultPlan(latency_s=0.25, sleep_fn=slept.append, scheduled=[
        FaultSpec(2, "train_step", FaultKind.LATENCY)])
    tr = _trainer(fault_plan=plan)
    _fit(tr)
    _assert_bitwise(tr, clean)
    assert slept == [0.25]


def test_eval_transient_retries_and_exhaustion_raises():
    val = SyntheticLanguageModeling(**{**LM, "seed": 9})
    plan = TrainFaultPlan(scheduled=[
        FaultSpec(0, "eval_step", FaultKind.TRANSIENT, count=2)])
    tr = _trainer(fault_plan=plan)
    want = _trainer().evaluate(val, steps=1)
    assert tr.evaluate(val, steps=1) == want
    assert tr.fault_stats["retries"] == 2
    plan = TrainFaultPlan(scheduled=[
        FaultSpec(0, "eval_step", FaultKind.TRANSIENT, count=4)])
    with pytest.raises(InjectedTransientError):
        _trainer(fault_plan=plan).evaluate(val, steps=1)


# ---------------------------------------------------- kill and resume
class _Batches:
    """A finite re-iterable dataset without ``with_offset``."""

    def __init__(self, n):
        self.batches = [_data().batch(i) for i in range(n)]

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("data,kill_at,fit_kw", [
    ("offset", 7, {}),                        # with_offset, mid-epoch
    ("skip", 7, {"steps_per_epoch": None}),   # host skip within an epoch
    ("wrap", 8, {}),                          # skip re-iterating 3 batches
], ids=["with_offset", "skip_in_epoch", "skip_reiterates"])
def test_kill_and_resume_is_bitwise(tmp_path, data, kill_at, fit_kw):
    make = {"offset": _data, "skip": lambda: _Batches(SPE),
            "wrap": lambda: _Batches(3)}[data]
    clean = _trainer()
    _fit(clean, make(), **fit_kw)
    plan = TrainFaultPlan(scheduled=[
        FaultSpec(kill_at, "train_step", FaultKind.KILL)])
    tr = _trainer(fault_plan=plan)
    with pytest.raises(KillPoint):
        _fit(tr, make(), callbacks=[_ckpt_cb(tmp_path)], **fit_kw)
    assert tr.step == kill_at
    meta = Checkpointer(str(tmp_path)).metadata()
    assert meta["loader"]["step_in_epoch"] == 6 - SPE * (6 // SPE)
    resumed = _trainer()
    _fit(resumed, make(), resume=str(tmp_path),
         callbacks=[_ckpt_cb(tmp_path)], **fit_kw)
    _assert_bitwise(resumed, tree_checksums(clean.state_dict()))
    assert resumed.history.history["loss"][-1] == \
        clean.history.history["loss"][-1]


def test_resume_of_an_empty_directory_starts_fresh(tmp_path, clean):
    tr = _trainer()
    _fit(tr, resume=str(tmp_path / "none_yet"))
    _assert_bitwise(tr, clean)


# ---------------------------------------------------- the checkpointer
def test_checkpoint_every_n_keeps_verified_saves(tmp_path):
    cb = _ckpt_cb(tmp_path, every=2, max_to_keep=2)
    tr = _trainer()
    _fit(tr, callbacks=[cb])
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.all_steps() == [10, 12] and cb.saves == 6
    state, meta = ckpt.restore()
    assert ckpt.verify(state, 12) and meta["loader"] == {
        "epoch": 3, "step_in_epoch": 0, "batches_consumed": 12}
    assert tree_checksums(state) == tree_checksums(tr.state_dict())
    assert tr.fault_stats["checkpoints_saved"] == 6
    for bad in (dict(max_to_keep=1), dict(every_n_steps=0)):
        with pytest.raises(ValueError):
            CheckpointEveryN(str(tmp_path), **bad)


def test_torn_or_tampered_newest_save_is_skipped(tmp_path):
    tr = _trainer()
    _fit(tr, epochs=1, callbacks=[_ckpt_cb(tmp_path, every=1)])
    ckpt = Checkpointer(str(tmp_path))
    meta_path = tmp_path / "4" / "meta.json"
    meta = json.loads(meta_path.read_text())
    key = next(k for k in meta["checksums"] if k.startswith("model/"))
    meta["checksums"][key] = "00000000"
    meta_path.write_text(json.dumps(meta))
    state, _ = ckpt.restore()
    assert state["step"] == 3
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(step=4)
    (tmp_path / "3" / "state.pt").write_bytes(b"torn")
    assert ckpt.restore()[0]["step"] == 2


def test_async_save_lands_and_restore_waits(tmp_path):
    tr = _trainer()
    _fit(tr, epochs=1)
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    ckpt.save(tr.state_dict(), epoch=0)
    assert ckpt.latest_step() == tr.step
    state, _ = ckpt.restore()
    assert tree_checksums(state) == tree_checksums(tr.state_dict())


def test_epoch_callbacks_and_initial_epoch(tmp_path):
    clean = _trainer()
    _fit(clean)
    best = ModelCheckpoint(str(tmp_path / "best"), monitor="loss",
                           save_best_only=True, async_save=False)
    backup = BackupAndRestore(str(tmp_path / "backup"), async_save=False)
    first = _trainer()
    _fit(first, epochs=2, callbacks=[best, backup])
    assert Checkpointer(str(tmp_path / "backup")).all_steps() == [4, 8]
    assert latest_epoch(str(tmp_path / "backup")) == 1
    saved = Checkpointer(str(tmp_path / "best")).all_steps()
    assert saved and saved[0] == 4
    # Epoch granularity: the caller repositions the stream itself.
    second = _trainer()
    _fit(second, _data().with_offset(2 * SPE),
         callbacks=[BackupAndRestore(str(tmp_path / "backup"),
                                     async_save=False)],
         initial_epoch=latest_epoch(str(tmp_path / "backup")) + 1)
    _assert_bitwise(second, tree_checksums(clean.state_dict()))


def test_save_params_npz(tmp_path):
    model = tiny_llama(vocab_size=VOCAB, max_len=32, device="cpu",
                       param_dtype=torch.bfloat16)
    save_params_npz(str(tmp_path / "params"), model)
    got = np.load(tmp_path / "params")
    assert set(got.files) == set(model.state_dict())
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(got[name], t.float().numpy())


# ---------------------------------------------------- preemption
class _Sigterm(Callback):
    def __init__(self, at):
        self.at = at

    def on_train_batch_end(self, step, logs):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


@pytest.mark.parametrize("delegated", [False, True])
def test_sigterm_saves_stops_and_resumes_bitwise(tmp_path, clean, delegated):
    before = signal.getsignal(signal.SIGTERM)
    every = _ckpt_cb(tmp_path, every=3)
    pre = (PreemptionCheckpoint(delegate=every) if delegated
           else PreemptionCheckpoint(str(tmp_path)))
    cbs = [every, pre] if delegated else [pre]
    tr = _trainer()
    _fit(tr, callbacks=cbs + [_Sigterm(4)])
    # The signal lands after the preemption hook of batch 4 ran: the save
    # is at the next boundary.
    assert pre.preempted and tr.step == 6 and _newest(tmp_path) == 6
    assert signal.getsignal(signal.SIGTERM) == before
    resumed = _trainer()
    _fit(resumed, resume=str(tmp_path))
    _assert_bitwise(resumed, clean)


def test_handlers_come_back_when_fit_raises(tmp_path):
    before = signal.getsignal(signal.SIGTERM)

    class Boom(Callback):
        def on_epoch_begin(self, epoch):
            raise RuntimeError("boom")

    pre = PreemptionCheckpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="boom"):
        _fit(_trainer(), callbacks=[pre, Boom()])
    assert signal.getsignal(signal.SIGTERM) == before
    with pytest.raises(ValueError, match="exactly one"):
        PreemptionCheckpoint()
