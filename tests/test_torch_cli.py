"""The port's command line against the JAX package's: the eight presets
(``config.py``), the model registry (``models/registry.py``) and
``run.py`` — the config ``main`` hands to ``run_experiment`` for a matrix
of argv, the refusals (exit 2 in both), what ``build_trainer`` derives for
each preset, ``build_data``'s batches and the first step's loss of the
trainer the CLI builds (from bridged weights) against the JAX CLI's, and
runs of every preset's tiny counterpart on the CPU with
each save format, the profiler and the pretrained flow; plus one
``multiworker`` run of ``python -m pddl_tpu_torch`` as two gloo
processes."""

import dataclasses
import functools
import glob
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu import config as jax_config
from pddl_tpu import run as jax_run
from pddl_tpu.models import registry as jax_registry

from pddl_tpu_torch import bridge
from pddl_tpu_torch import config as port_config
from pddl_tpu_torch import run as port_run
from pddl_tpu_torch.models import registry as port_registry

from _torch_cluster import Cluster

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TINY_IMAGE = dict(model="tiny_resnet", num_classes=8, image_size=32,
                  crop=32, per_replica_batch=2, val_per_replica_batch=2,
                  compute_dtype="float32", verbose=0, data_dir=None)


# ---------------------------------------------------------- config + registry
def test_presets_equal_jax_field_by_field():
    assert sorted(port_config.PRESETS) == sorted(jax_config.PRESETS)
    assert len(port_config.PRESETS) == 8
    for name, cfg in port_config.PRESETS.items():
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jax_config.PRESETS[name])), name
    assert (dataclasses.asdict(port_config.ExperimentConfig())
            == dataclasses.asdict(jax_config.ExperimentConfig()))
    got = port_config.get_preset("hvd", epochs=3, crop=96)
    want = jax_config.get_preset("hvd", epochs=3, crop=96)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    errors = []
    for pkg in (port_config, jax_config):
        with pytest.raises(ValueError, match="unknown preset") as info:
            pkg.get_preset("nope")
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_registry_names_match_jax():
    assert port_registry.list_models() == jax_registry.list_models()
    assert len(port_registry.list_models()) == 16
    assert port_registry.LM_MODELS == jax_registry.LM_MODELS
    assert port_registry.REMAT_MODELS == jax_registry.REMAT_MODELS
    for pkg in (port_registry, jax_registry):
        with pytest.raises(KeyError, match="unknown model 'nope'"):
            pkg.get_model("nope")


def _jax_params(jm, x):
    variables = jm.init(jax.random.key(3), jnp.asarray(x), train=False)
    return jax.tree.map(np.asarray, variables)


@pytest.mark.parametrize("name", ["tiny_resnet", "tiny_vit", "tiny_gpt",
                                  "tiny_llama"])
def test_registry_models_give_jax_logits(name):
    """Built by name in both packages, with the JAX weights bridged into
    the port's model: the logits agree within the families' model tests'
    1e-5 (ResNet in eval mode, the LM adapter's vocabulary from
    ``num_classes``)."""
    rng = np.random.RandomState(0)
    kw = dict(num_classes=16, bn_mode="train")
    if name in port_registry.LM_MODELS:
        x = rng.randint(0, 16, (2, 12)).astype(np.int32)
    else:
        x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = jax_registry.get_model(name, **kw)
    variables = _jax_params(jm, x)
    tm = port_registry.get_model(name, device="cpu", seed=1, **kw)
    if name == "tiny_resnet":
        sd = bridge.resnet_params_from_jax(variables["params"],
                                           variables["batch_stats"])
    else:
        sd = {"tiny_vit": bridge.vit_params_from_jax,
              "tiny_gpt": bridge.gpt_params_from_jax,
              "tiny_llama": bridge.llama_params_from_jax}[name](
                  variables["params"])
    tm.load_state_dict(sd)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.as_tensor(x), train=False).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_registry_passes_device_and_seed_through():
    a = port_registry.get_model("tiny_llama", device="cpu", seed=4)
    b = port_registry.get_model("tiny_llama", device="cpu", seed=4)
    c = port_registry.get_model("tiny_llama", device="cpu", seed=5)
    assert a.vocab_size == 64  # num_classes 0 falls back to 64
    assert a.device == torch.device("cpu")
    for (n, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), n
    assert any(not torch.equal(y, z) for y, z in zip(
        b.state_dict().values(), c.state_dict().values()))


# --------------------------------------------------------------- the CLI
ARGV = [
    [],
    ["--preset", "hvd", "--synthetic", "--epochs", "2"],
    ["--preset", "single-pretrained", "--pretrained-h5", "w.h5",
     "--download-weights"],
    ["--preset", "mirrored-pretrained", "--batch", "16", "--lr", "0.01"],
    ["--preset", "multiworker", "--data-dir", "/data", "--synthetic"],
    ["--preset", "multiworker-pretrained", "--image-size", "160",
     "--crop", "128", "--bn-momentum", "0.9", "--synthetic-signal", "4"],
    ["--preset", "ps", "--steps-per-epoch", "7", "--seed", "3",
     "--verbose", "0", "--num-classes", "10"],
    ["--preset", "mirrored", "--lr-schedule", "warmup_cosine",
     "--lr-decay-steps", "100", "--lr-warmup-steps", "10",
     "--grad-accum", "4", "--ema-decay", "0.999"],
    ["--lr-schedule", "piecewise", "--lr-boundaries", "30:0.1,60:0.5"],
    ["--model", "tiny_llama", "--seq-len", "32", "--vocab-multiple", "8",
     "--remat", "dots", "--param-update", "stochastic_round"],
    ["--model", "vit_s16", "--remat", "full", "--stem", "keras"],
    ["--model", "resnet50", "--stem", "space_to_depth"],
    ["--strategy", "tensor_parallel", "--model-parallel", "2",
     "--model", "tiny_llama"],
    ["--strategy", "expert_parallel", "--expert-parallel", "2",
     "--model-parallel", "1"],
    ["--checkpoint-dir", "ck", "--checkpoint-every-steps", "5", "--resume",
     "--save", "out.h5", "--profile-dir", "prof"],
]
REFUSED = [
    ["--lr-boundaries", "30-0.1"],
    ["--lr-boundaries", "x:1"],
    ["--model-parallel", "2"],
    ["--strategy", "mirrored", "--model-parallel", "2"],
    ["--expert-parallel", "2", "--strategy", "tensor_parallel"],
    ["--strategy", "expert_parallel"],
    ["--preset", "nope"],
    ["--strategy", "pipeline"],
    ["--remat", "some"],
    ["--epochs", "two"],
]


def _parsed(monkeypatch, argv):
    """The config each package's ``main`` hands to ``run_experiment``."""
    seen = {}

    def record(pkg):
        def fake(cfg, *args, **kwargs):
            seen[pkg] = (cfg, kwargs)
        return fake

    monkeypatch.setattr(port_run, "run_experiment", record("port"))
    monkeypatch.setattr(jax_run, "run_experiment", record("jax"))
    assert port_run.main(list(argv)) == 0
    assert jax_run.main(list(argv)) == 0
    return seen["port"], seen["jax"]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a) or "none")
def test_cli_builds_the_jax_config(monkeypatch, argv):
    (port_cfg, port_kw), (jax_cfg, _) = _parsed(monkeypatch, argv)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert port_kw == {"device": "cuda"}


def test_cli_device_flag(monkeypatch):
    """``--device`` (the port's one new flag, the JAX CLI's
    ``JAX_PLATFORMS``) reaches ``run_experiment``; ``main(device=)`` sets
    its default."""
    seen = []
    monkeypatch.setattr(port_run, "run_experiment",
                        lambda cfg, **kw: seen.append(kw))
    assert port_run.main(["--device", "cpu"]) == 0
    assert port_run.main([], device="cpu") == 0
    assert port_run.main(["--device", "cuda"], device="cpu") == 0
    assert seen == [{"device": "cpu"}, {"device": "cpu"},
                    {"device": "cuda"}]
    with pytest.raises(SystemExit) as info:
        port_run.main(["--device", "tpu"])
    assert info.value.code == 2


@pytest.mark.parametrize("argv", REFUSED, ids=" ".join)
def test_cli_refusals_exit_2_in_both(monkeypatch, argv):
    for pkg in (port_run, jax_run):
        monkeypatch.setattr(pkg, "run_experiment", lambda *a, **k: None)
        with pytest.raises(SystemExit) as info:
            pkg.main(list(argv))
        assert info.value.code == 2


def test_main_raises_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.main(["--preset", "single", "--synthetic", "--model",
                       "tiny_resnet", "--steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.build_trainer(port_config.get_preset("single"))


class _Recorded:
    """Stands in for a Trainer (or the augment factories): keeps the
    keyword arguments it was built with."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        self.strategy = kwargs.get("strategy")


def _derived(monkeypatch, pkg, cfg, **kw):
    """What ``build_trainer`` derives: the Trainer's keywords, the crop
    handed to the augment and the eval transform, and the callbacks."""
    name = pkg.__name__.split(".")[0]
    crops = []

    def factory(crop=None, **_):
        crops.append(crop)
        return crop

    for attr in ("standard_augment", "standard_eval_transform"):
        monkeypatch.setattr(f"{name}.ops.augment.{attr}", factory)
    monkeypatch.setattr(f"{name}.train.loop.Trainer", _Recorded)
    trainer, callbacks = pkg.build_trainer(cfg, **kw)
    out = dict(trainer.kwargs)
    strategy = out.pop("strategy")
    replicas = strategy.num_replicas_in_sync
    out["lr_per_replica"] = (out.pop("learning_rate") / replicas
                             if cfg.scale_lr else None)
    out.pop("augment", None), out.pop("eval_transform", None)
    return out, crops, [type(c).__name__ for c in callbacks]


@pytest.mark.parametrize("preset", sorted(port_config.PRESETS))
@pytest.mark.parametrize("family", ["image", "lm"])
def test_build_trainer_derives_what_jax_does(monkeypatch, tmp_path, preset,
                                             family):
    """Per preset at a tiny model: the learning rate after ``scale_lr``
    (per replica: the JAX side runs on 8 fake devices, the port on one
    process), the schedule's ``decay_steps``, the optimizer options, the
    input and target keys, the crop and the callbacks' class names in
    order."""
    cfg = port_config.get_preset(preset)
    if family == "lm":
        cfg = cfg.replace(model="tiny_llama", seq_len=16, num_classes=64,
                          verbose=0)
    else:
        cfg = cfg.replace(model="tiny_resnet", num_classes=8, image_size=24,
                          lr_schedule="cosine", steps_per_epoch=5,
                          epochs=3, gradient_accumulation_steps=2,
                          profile_dir=str(tmp_path / "p"),
                          checkpoint_dir=str(tmp_path / "ck"))
    jax_cfg = jax_config.ExperimentConfig(**dataclasses.asdict(cfg))
    port = _derived(monkeypatch, port_run, cfg, device="cpu")
    want = _derived(monkeypatch, jax_run, jax_cfg)
    assert port == want
    if family == "image":
        assert port[0]["lr_schedule_options"] == {"decay_steps": 7}
        assert port[1] == [min(cfg.crop or 24, 24)] * 2
        assert "Profiler" in port[2] and "ModelCheckpoint" in port[2]


# ------------------------------------------------------------------ runs
def _corpus(root):
    rng = np.random.default_rng(2)
    text = bytes(rng.integers(32, 127, 6000, dtype=np.uint8))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "train.txt"), "wb") as f:
        f.write(text)
    return root


@functools.lru_cache(maxsize=None)
def _jax_history_keys(family: str) -> list:
    """The History keys of one JAX run of the family (one run each)."""
    if family == "image":
        cfg = jax_config.get_preset("single").replace(**TINY_IMAGE,
                                                      epochs=1)
    else:
        cfg = jax_config.get_preset("single").replace(
            model="tiny_llama", seq_len=16, num_classes=64,
            per_replica_batch=2, epochs=1, compute_dtype="float32",
            verbose=0, data_dir=None)
    hist = jax_run.run_experiment(cfg, steps_per_epoch=2,
                                  validation_steps=1)
    return sorted(hist.history)


@pytest.mark.parametrize("preset", sorted(port_config.PRESETS))
def test_every_preset_trains_tiny_on_the_cpu(preset):
    """Every preset's tiny counterpart (the pretrained ones without their
    weights file: the pretrained flow has its own test), world size 1: 2
    steps an epoch to finite losses, with the JAX run's History keys."""
    cfg = port_config.get_preset(preset).replace(
        **TINY_IMAGE, epochs=2, weights=None)
    hist = port_run.run_experiment(cfg, steps_per_epoch=2,
                                   validation_steps=1, device="cpu")
    losses = hist.history["loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert sorted(hist.history) == _jax_history_keys("image")


@pytest.mark.parametrize("model", ["tiny_llama", "tiny_gpt"])
@pytest.mark.parametrize("data", ["synthetic", "corpus"])
def test_lm_runs_on_the_cpu(monkeypatch, tmp_path, model, data):
    argv = ["--preset", "single", "--model", model, "--batch", "2",
            "--seq-len", "16", "--epochs", "1", "--steps-per-epoch", "2",
            "--verbose", "0", "--device", "cpu"]
    if data == "corpus":
        argv += ["--data-dir", _corpus(str(tmp_path / "c")),
                 "--num-classes", "256"]
    seen = {}
    real = port_run.run_experiment

    def run(cfg, **kw):
        seen["hist"] = real(cfg, **kw)

    monkeypatch.setattr(port_run, "run_experiment", run)
    assert port_run.main(argv) == 0
    hist = seen["hist"]
    assert np.isfinite(hist.history["loss"]).all()
    assert sorted(hist.history) == _jax_history_keys("lm")


TINY_LM = dict(model="tiny_llama", seq_len=16, num_classes=64,
               per_replica_batch=2, val_per_replica_batch=3,
               compute_dtype="float32", verbose=0, data_dir=None)
WIRING = {
    # No flip, and the crop the image's size: the augment draws nothing.
    "image": dict(TINY_IMAGE, flip=False, seed=4, synthetic_signal=2.0),
    "lm-synthetic": dict(TINY_LM, seed=4),
    "lm-corpus": dict(TINY_LM, num_classes=256),
}


def _wired(pkg, cfg, **kw):
    """What ``run_experiment`` wires before ``fit`` at world size 1: the
    strategy, then ``build_trainer``'s trainer, then ``build_data``."""
    if pkg is port_run:
        from pddl_tpu_torch.parallel import get_strategy
    else:
        from pddl_tpu.parallel.base import get_strategy
    strategy = get_strategy(cfg.strategy, **kw, **pkg._strategy_options(cfg))
    strategy.setup()
    trainer, _ = pkg.build_trainer(cfg, strategy)
    return trainer, pkg.build_data(cfg, strategy)


def _first(data, n):
    batches = list(itertools.islice(iter(data), n))
    assert len(batches) == n
    return batches


@pytest.mark.parametrize("case", sorted(WIRING))
def test_cli_data_and_first_loss_match_jax(tmp_path, case):
    """The port CLI's wiring against the JAX CLI's, from one config:
    ``build_data``'s train and validation batches equal element for
    element (the seed, the batch sizes, the validation offset, the data
    source), and the trainer ``build_trainer`` makes, holding the JAX
    trainer's initial weights through the bridge, takes its first step
    on the first batch to the JAX loss within the model tests' rtol
    1e-5."""
    over = dict(WIRING[case])
    cfgs = {}
    for name, cfg_mod in (("port", port_config), ("jax", jax_config)):
        if case == "lm-corpus":  # each package prepares its own copy
            over["data_dir"] = _corpus(str(tmp_path / name))
        cfgs[name] = cfg_mod.get_preset("single").replace(**over)
    port_tr, (port_train, port_val) = _wired(port_run, cfgs["port"],
                                             device="cpu")
    jax_tr, (jax_train, jax_val) = _wired(jax_run, cfgs["jax"])
    firsts = []
    for got_data, want_data, n in ((port_train, jax_train, 3),
                                   (port_val, jax_val, 2)):
        want_batches = _first(want_data, n)
        firsts.append(want_batches[0])
        for got, want in zip(_first(got_data, n), want_batches):
            assert set(got) == set(want)
            for key in got:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])
    # Each train iterable has made one pass, so ``fit``'s is the second
    # in both (a corpus reshuffles on every pass).
    jax_tr.init_state(firsts[0])
    params = jax.tree.map(np.asarray, jax_tr.state.params)
    if case == "image":
        sd = bridge.resnet_params_from_jax(
            params, jax.tree.map(np.asarray, jax_tr.state.batch_stats))
    else:
        sd = bridge.llama_params_from_jax(params)
    port_tr.model.load_state_dict(sd)
    jh = jax_tr.fit(jax_train, epochs=1, steps_per_epoch=1, verbose=0)
    th = port_tr.fit(port_train, epochs=1, steps_per_epoch=1, verbose=0)
    assert np.isfinite(th.history["loss"]).all()
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-5)


def _narrow_resnet50(**kw):
    from pddl_tpu_torch.models.resnet import ResNet50

    return ResNet50(width_multiplier=0.0625, **kw)


@pytest.fixture
def narrow_resnet():
    port_registry.register_model("resnet50_test_narrow", _narrow_resnet50)
    yield "resnet50_test_narrow"
    port_registry._REGISTRY.pop("resnet50_test_narrow")


def _run_and_save(tmp_path, model, suffix, **over):
    path = str(tmp_path / f"model{suffix}")
    cfg = port_config.get_preset("single").replace(
        **{**TINY_IMAGE, "model": model, "save_path": path,
           "epochs": 1, **over})
    hist = port_run.run_experiment(cfg, steps_per_epoch=2,
                                   validation_steps=1, device="cpu")
    assert np.isfinite(hist.history["loss"]).all()
    return path


def test_saves_read_back(monkeypatch, tmp_path, narrow_resnet):
    """``.h5`` (a ResNet: the Keras file), ``.shlo`` (the serving
    artifact) and any other path (an npz of the state): each written file
    loads back through the port's loader; with EMA the export holds the
    shadows, and the live weights are put back after it."""
    from pddl_tpu_torch.ckpt import (load_inference_artifact,
                                     load_keras_resnet50_h5)

    h5 = _run_and_save(tmp_path, narrow_resnet, ".h5")
    fresh = _narrow_resnet50(num_classes=8, device="cpu", seed=9)
    load_keras_resnet50_h5(h5, fresh)
    shlo = _run_and_save(tmp_path, "tiny_resnet", ".shlo")
    call, exported = load_inference_artifact(shlo, device="cpu")
    out = call(torch.zeros(1, 32, 32, 3))
    assert tuple(out.shape) == (1, 8)

    seen = {}
    real = port_run._save

    def save(cfg, trainer, strategy):
        seen["live"] = {k: v.clone()
                        for k, v in trainer.model.state_dict().items()}
        seen["ema"] = {k: v.clone() for k, v in trainer.ema.items()}
        real(cfg, trainer, strategy)
        seen["after"] = trainer.model.state_dict()

    monkeypatch.setattr(port_run, "_save", save)
    npz = _run_and_save(tmp_path, "tiny_resnet", ".npz", ema_decay=0.5)
    with np.load(npz) as f:
        arrays = dict(f)
    assert set(arrays) == set(seen["live"])
    for name, value in arrays.items():
        want = seen["ema"].get(name, seen["live"][name])
        np.testing.assert_array_equal(value, want.numpy())
        assert torch.equal(seen["after"][name], seen["live"][name])


def test_profile_dir_writes_a_trace(tmp_path):
    prof = str(tmp_path / "prof")
    assert port_run.main([
        "--preset", "single", "--synthetic", "--model", "tiny_resnet",
        "--num-classes", "8", "--image-size", "32", "--batch", "2",
        "--epochs", "1", "--steps-per-epoch", "4", "--verbose", "0",
        "--device", "cpu", "--profile-dir", prof]) == 0
    assert glob.glob(os.path.join(prof, "*.pt.trace.json"))


def test_pretrained_h5_flow(tmp_path, narrow_resnet):
    """``--pretrained-h5``: the Keras file's weights land in the live
    model (and its EMA shadows) before training; the run trains on."""
    from pddl_tpu_torch.ckpt import export_keras_style_h5

    donor = _narrow_resnet50(num_classes=8, device="cpu", seed=5)
    path = str(tmp_path / "pre.h5")
    export_keras_style_h5(path, donor)
    cfg = port_config.get_preset("single-pretrained").replace(
        **{**TINY_IMAGE, "model": narrow_resnet, "pretrained_h5": path,
           "epochs": 1, "ema_decay": 0.9})
    trainer, _ = port_run.build_trainer(cfg, device="cpu")
    port_run._load_pretrained(trainer, cfg, None, path)
    for name, t in donor.state_dict().items():
        if name != "num_batches_tracked":
            assert torch.equal(trainer.model.state_dict()[name], t), name
    for name, t in trainer.ema.items():
        assert torch.equal(t, donor.state_dict()[name]), name
    hist = port_run.run_experiment(cfg, steps_per_epoch=1,
                                   validation_steps=1, device="cpu")
    assert np.isfinite(hist.history["loss"][-1])


def test_multiworker_two_gloo_processes(tmp_path):
    """``python -m pddl_tpu_torch --preset multiworker`` as two processes
    over gloo (world size 2, each feeding its part of the global batch):
    both exit 0, and the coordinator alone writes the save."""
    save = str(tmp_path / "mw.npz")
    cluster = Cluster("-m", 2, "pddl_tpu_torch", "--preset", "multiworker",
                      "--synthetic", "--device", "cpu", "--model",
                      "tiny_resnet", "--num-classes", "8", "--image-size",
                      "32", "--batch", "2", "--epochs", "1",
                      "--steps-per-epoch", "2", "--verbose", "1",
                      "--save", save)
    outputs = cluster.wait(timeout=180.0)
    assert "Epoch 1/1" in outputs[0] and "Epoch 1/1" not in outputs[1]
    with np.load(save) as f:
        assert "head.weight" in f
