"""The port's examples (`examples_torch/`) against the JAX package's
(`examples/`): the dataset builders and the history writer give the same
bytes, every example runs in smoke mode on the host (`--device cpu`), the
workflow rehearsal passes its obligations, and the rehearsal's `.h5` leg
re-imports a ResNet-50 with logits equal to its checkpoint's."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from examples_torch import real_data_convergence as port_rdc  # noqa: E402
from examples_torch import workflow_rehearsal as port_wr  # noqa: E402

# Children run one thread each: several run at once, and a torch process
# that takes every core stalls beside its siblings.
CHILD_ENV = dict(
    {k: v for k, v in os.environ.items()
     if k not in ("XLA_FLAGS", "JAX_PLATFORMS")},
    PDDL_EXAMPLE_SMOKE="1", OMP_NUM_THREADS="1",
    PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _jax_example(name):
    """A JAX example module, loaded from its file (no jax at import)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_rdc = _jax_example("real_data_convergence")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A work dir holding the port's corpus (the stdlib capped at 1 MB)
    and its digits folder, which the builder comparisons read and the
    smoke runs train on."""
    root = tmp_path_factory.mktemp("examples_work")
    port_rdc.build_python_corpus(str(root / "pycorpus"), max_bytes=1 << 20)
    port_rdc.build_digits_folder(str(root / "digits_png"))
    return root


def _tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _source_tree(root: pathlib.Path) -> pathlib.Path:
    """A small seeded source tree: nested packages, files that are not
    Python, and the two directory kinds the walk skips."""
    rng = np.random.default_rng(0)
    for rel in ("a.py", "b.txt", "pkg/__init__.py", "pkg/z.py", "pkg/m.py",
                "pkg/sub/deep.py", "site-packages/skip.py",
                "__pycache__/skip.py", "q/r.py"):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(rng.integers(32, 127, int(rng.integers(50, 400)),
                                      dtype=np.uint8).tobytes())
    return root


@pytest.mark.parametrize("source", ["small_tree", "stdlib_1mb"])
def test_python_corpus_byte_identical_to_jax(source, work, tmp_path):
    if source == "small_tree":
        kw = dict(source_dir=str(_source_tree(tmp_path / "src")),
                  max_bytes=1500)
        got = port_rdc.build_python_corpus(str(tmp_path / "port"), **kw)
        port_dir = tmp_path / "port"
    else:
        kw = dict(max_bytes=1 << 20)
        got = json.loads(json.dumps({
            "train_bytes": (work / "pycorpus" / "train.txt").stat().st_size,
            "val_bytes": (work / "pycorpus" / "val.txt").stat().st_size}))
        port_dir = work / "pycorpus"
    want = jax_rdc.build_python_corpus(str(tmp_path / "jax"), **kw)
    assert got == want
    assert _tree(port_dir) == _tree(tmp_path / "jax")
    assert want["train_bytes"] > 0 and want["val_bytes"] > 0


def test_digits_folder_same_files_and_pixels(work, tmp_path):
    from PIL import Image

    want = jax_rdc.build_digits_folder(str(tmp_path / "jax"))
    port_root, jax_root = work / "digits_png", tmp_path / "jax"
    names = sorted(str(p.relative_to(port_root))
                   for p in port_root.rglob("*.png"))
    assert names == sorted(str(p.relative_to(jax_root))
                           for p in jax_root.rglob("*.png"))
    assert len(names) == want["train"] + want["validation"] == 1797
    for name in names:
        a = np.asarray(Image.open(port_root / name))
        b = np.asarray(Image.open(jax_root / name))
        assert a.shape == (32, 32, 3) and np.array_equal(a, b), name


def test_write_history_same_header_and_epoch_keys(tmp_path):
    from pddl_tpu_torch.train.history import History

    hist = History()
    rng = np.random.default_rng(1)
    for epoch in range(4):
        logs = {"loss": float(rng.random()), "val_loss": float(rng.random()),
                "accuracy": float(rng.random())}
        if epoch < 2:
            logs["lr"] = 1e-3 / (epoch + 1)
        hist.append(epoch, logs)
    header = {"track": "pycorpus", "sizes": {"train_bytes": 3,
                                             "val_bytes": 1},
              "steps": 3000, "learning_rate": 3e-4}
    port_rdc._write_history(str(tmp_path / "port.jsonl"), header, hist)
    jax_rdc._write_history(str(tmp_path / "jax.jsonl"), header, hist)
    got = (tmp_path / "port.jsonl").read_text()
    assert got == (tmp_path / "jax.jsonl").read_text()
    rows = [json.loads(line) for line in got.splitlines()]
    assert rows[0] == {"config": header}
    assert [sorted(r) for r in rows[1:]] == (
        [["accuracy", "epoch", "loss", "lr", "val_loss"]] * 2
        + [["accuracy", "epoch", "loss", "val_loss"]] * 2)


def _run_all(jobs, log_dir, deadline_s):
    """Start every ``(name, argv)`` at once, each writing to its own file
    (a pipe drained in turn would stall a child past the OS buffer). One
    deadline for all; survivors are killed. Returns the failures and
    every child's output."""
    procs, logs = {}, {}
    try:
        for name, argv in jobs:
            logs[name] = open(log_dir / f"{name}.log", "w+")
            procs[name] = subprocess.Popen(
                [sys.executable, *argv], env=CHILD_ENV, cwd=str(REPO),
                stdout=logs[name], stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + deadline_s
        failures = []
        for name, p in procs.items():
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            logs[name].seek(0)
            out = logs[name].read()
            if p.returncode != 0:
                failures.append(f"{name} (rc={p.returncode}):\n{out[-3000:]}")
        return failures, {n: (f.seek(0), f.read())[1] for n, f in logs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()


def test_every_example_runs_in_smoke_mode_on_the_host(work, tmp_path):
    """Every example but the rehearsal, launched at once under one
    deadline; the corpus and digits tracks read the work dir's builds."""
    ex = REPO / "examples_torch"

    def job(name, script, *args):
        return name, [str(ex / script), "--device", "cpu", *args]

    failures, outs = _run_all([
        job("real_data_convergence", "real_data_convergence.py",
            "--work-dir", str(work), "--artifacts-dir", str(tmp_path / "a")),
        job("generate_python", "generate_python.py", "--work-dir", str(work),
            "--out", str(tmp_path / "samples.txt")),
        job("generate_python_speculative", "generate_python.py",
            "--speculative", "--work-dir", str(work),
            "--out", str(tmp_path / "samples_spec.txt")),
        job("long_context_gpt", "long_context_gpt.py"),
        job("train_resnet_mirrored", "train_resnet_mirrored.py"),
        job("shard_everything", "shard_everything.py"),
    ], tmp_path, deadline_s=240)
    assert not failures, "\n\n".join(failures)
    for track in ("digits", "pycorpus", "pycorpus_llama"):
        rows = (tmp_path / "a" / f"{track}.jsonl").read_text().splitlines()
        assert json.loads(rows[0])["config"]["device"] == "cpu"
        assert len(rows) == 3 and "val_loss" in json.loads(rows[-1])
    spec = (tmp_path / "samples_spec.txt").read_text().splitlines()[1]
    stats = json.loads(spec[2:])["speculative"]
    assert 0.0 <= stats["sampling"]["acceptance_rate"] <= 1.0
    assert 0.0 <= stats["greedy"]["acceptance_rate"] <= 1.0
    assert "sharded generation:" in outs["shard_everything"]


def test_workflow_rehearsal_smoke(tmp_path):
    """The four-leg rehearsal (preempt → resume → export → re-import) in
    smoke mode, run alone: its two legs run one after the other."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" /
                             "workflow_rehearsal.py"), "--device", "cpu",
         "--work-dir", str(tmp_path / "work"),
         "--artifacts-dir", str(tmp_path / "art")],
        env=CHILD_ENV, cwd=str(REPO), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "REHEARSAL PASS" in proc.stdout
    rec = json.loads((tmp_path / "art" /
                      "workflow_rehearsal.json").read_text())
    assert rec["config"]["final_format"] == "npz"
    assert rec["final_vs_checkpoint_max_logit_delta"] == 0.0
    assert rec["npz_vs_checkpoint_max_param_delta"] == 0.0
    assert rec["leg1_preempted"]["checkpoint_steps"]
    assert rec["resumed_at_interrupted_epoch"]


def test_rehearsal_h5_leg_reimports_resnet50_bitwise(tmp_path):
    """Leg 4's `.h5` form: a ResNet-50 after one step, checkpointed and
    exported as the Keras-layout `.h5`, re-imports with logits equal to
    the checkpoint's and the checkpoint's learning rate."""
    from pddl_tpu_torch.ckpt.checkpoint import Checkpointer
    from pddl_tpu_torch.ckpt.keras_import import export_keras_style_h5
    from pddl_tpu_torch.models.resnet import ResNet50
    from pddl_tpu_torch.train.loop import Trainer

    plan = port_wr.Plan(model="resnet50", image=32, batch=2, num_classes=16,
                        epochs=1, steps=1, marker_epoch=1, sigterm_after=1)
    model = ResNet50(num_classes=16, bn_momentum=0.9, device="cpu")
    trainer = Trainer(model, optimizer="adam", learning_rate=1e-3,
                      device="cpu")
    gen = np.random.default_rng(0)
    trainer.train_step({
        "image": gen.standard_normal((2, 32, 32, 3)).astype(np.float32),
        "label": np.array([3, 7], np.int32)})
    Checkpointer(str(tmp_path / "ckpt"),
                 async_save=False).save_trainer(trainer)
    final = str(tmp_path / "final.h5")
    export_keras_style_h5(final, model)
    lr, delta, params = port_wr._logits_delta(plan, "cpu",
                                              str(tmp_path / "ckpt"), final)
    assert lr == 1e-3 and params is None
    assert delta == 0.0
    # The same leg tells a different model apart.
    with torch.no_grad():
        list(model.parameters())[-1].add_(1.0)
    export_keras_style_h5(final, model)
    assert port_wr._logits_delta(plan, "cpu", str(tmp_path / "ckpt"),
                                 final)[1] > 0.0
