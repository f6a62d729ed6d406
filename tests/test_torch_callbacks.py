"""The port's remaining callbacks (`pddl_tpu_torch/train/callbacks.py`:
`ModelSummary`, `LambdaCallback`, `CSVLogger`, `TensorBoard`, `Timing`)
and `utils/summary.py` against the JAX package's on the CPU.

- `TensorBoard` writes its event files without TensorFlow; read back with
  `tf.compat.v1.train.summary_iterator`, they hold record for record what
  the JAX callback's `tf.summary.scalar` writes — the version event, then
  per epoch each metric (and `learning_rate`) at `step=epoch` as a scalar
  f32 tensor under the `scalars` plugin, `val_` metrics in `validation/`
  under their bare names — with the values of each trainer's own run
  (rtol 1e-5, the two trainers' losses' agreement) and every file's
  TFRecord checksums verified by the reader;
- `CSVLogger` writes the JAX callback's header and rows (values within
  rtol 1e-5);
- `ModelSummary` prints `param_summary`, whose total and BatchNorm-stats
  counts are the JAX summary's for the same model; `format_table` is the
  JAX function's text, and the serving metrics use it;
- `LambdaCallback` calls each function with the port's hook arguments;
  `Timing` prints the total on train end;
- under a schedule, a callback's write to the learning rate is
  overwritten at the next update, as in JAX.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.models.resnet as jres
import pddl_tpu_torch.models.resnet as tres
from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.train.callbacks import CSVLogger as JaxCSVLogger
from pddl_tpu.train.callbacks import TensorBoard as JaxTensorBoard
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.state import get_learning_rate as jax_get_lr
from pddl_tpu.utils.summary import format_table as jax_format_table
from pddl_tpu.utils.summary import param_summary as jax_param_summary
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.serve import metrics as serve_metrics
from pddl_tpu_torch.train.callbacks import (
    CSVLogger,
    LambdaCallback,
    ModelSummary,
    TensorBoard,
    Timing,
)
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import get_learning_rate, set_learning_rate
from pddl_tpu_torch.utils.summary import format_table, param_summary

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VOCAB = 64
LM = dict(batch_size=4, seq_len=16, vocab_size=VOCAB, seed=3)
KEYS = dict(input_key="tokens", target_key="targets")


def _pair(**kw):
    jtr = JaxTrainer(jax_tiny_llama(vocab_size=VOCAB, max_len=32),
                     optimizer="sgd", learning_rate=0.1, seed=0, **KEYS, **kw)
    jtr.init_state(JaxLM(**LM).batch(0))
    tm = tiny_llama(vocab_size=VOCAB, max_len=32, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    return jtr, Trainer(tm, optimizer="sgd", learning_rate=0.1, seed=0,
                        device="cpu", **KEYS, **kw)


def _fit_both(jtr, tr, jcb, tcb, epochs=2):
    val = dict(validation_steps=1)
    jtr.fit(JaxLM(**LM), epochs=epochs, steps_per_epoch=2, verbose=0,
            callbacks=jcb, validation_data=JaxLM(**{**LM, "seed": 9}), **val)
    tr.fit(SyntheticLanguageModeling(**LM), epochs=epochs, steps_per_epoch=2,
           verbose=0, callbacks=tcb, validation_data=SyntheticLanguageModeling(
               **{**LM, "seed": 9}), **val)


def _records(log_dir):
    import tensorflow as tf

    out = {}
    for split in ("train", "validation"):
        files = glob.glob(os.path.join(log_dir, split, "events.out.*"))
        assert len(files) == 1, files
        rows = []
        for event in tf.compat.v1.train.summary_iterator(files[0]):
            if event.HasField("file_version"):
                rows.append(("version", event.file_version))
                continue
            for v in event.summary.value:
                value = tf.make_ndarray(v.tensor)
                rows.append((event.step, v.tag, v.metadata.plugin_data
                             .plugin_name, value.dtype.name, value.shape,
                             float(value)))
        out[split] = rows
    return out


def test_tensorboard_event_files_match_the_jax_callbacks(tmp_path):
    jtr, tr = _pair()
    _fit_both(jtr, tr, [JaxTensorBoard(str(tmp_path / "jax"))],
              [TensorBoard(str(tmp_path / "port"))])
    want, got = _records(str(tmp_path / "jax")), _records(
        str(tmp_path / "port"))
    for split in ("train", "validation"):
        assert len(got[split]) == len(want[split]) > 1
        for g, w in zip(got[split], want[split]):
            assert g[:-1] == w[:-1]
            if g[0] != "version" and g[1] != "images_per_sec":  # wall clock
                assert g[-1] == pytest.approx(w[-1], rel=1e-5), g
    tags = {r[1] for r in got["validation"] if r[0] != "version"}
    assert tags == {"loss", "accuracy"}
    assert ("learning_rate" in {r[1] for r in got["train"]})


def test_csv_logger_writes_the_jax_rows(tmp_path):
    jtr, tr = _pair()
    _fit_both(jtr, tr, [JaxCSVLogger(str(tmp_path / "jax.csv"))],
              [CSVLogger(str(tmp_path / "port.csv"))])
    want = (tmp_path / "jax.csv").read_text().splitlines()
    got = (tmp_path / "port.csv").read_text().splitlines()
    assert got[0] == want[0] and len(got) == len(want) == 3
    keys = got[0].split(",")
    for g, w in zip(got[1:], want[1:]):
        for k, a, b in zip(keys, g.split(","), w.split(",")):
            if k == "images_per_sec":  # a wall-clock rate
                continue
            assert float(a) == pytest.approx(float(b), rel=1e-5), k


def test_model_summary_counts_are_the_jax_summarys(capsys):
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=32)
    params = jm.init(jax.random.key(0), jnp.ones((1, 4), jnp.int32),
                     train=False)["params"]
    tm = tiny_llama(vocab_size=VOCAB, max_len=32, device="cpu")
    jr = jres.tiny_resnet()
    variables = jr.init(jax.random.key(0), jnp.ones((1, 32, 32, 3)),
                        train=False)
    tr_model = tres.tiny_resnet(device="cpu")

    def tail(text):  # the TOTAL and batch-stats rows' numbers
        rows = [line.split() for line in text.splitlines()
                if "TOTAL" in line or "batch stats" in line]
        return [r[-3] if "TOTAL" in r else r[-1] for r in rows]

    assert tail(param_summary(tm)) == tail(jax_param_summary(params))
    assert tail(param_summary(tr_model)) == tail(jax_param_summary(
        variables["params"], variables["batch_stats"]))
    tr = Trainer(tm, device="cpu", **KEYS)
    tr.fit(SyntheticLanguageModeling(**LM), steps_per_epoch=1, verbose=0,
           callbacks=[ModelSummary(), Timing()])
    err = capsys.readouterr().err
    assert err.startswith(param_summary(tm)) and "Total time:" in err


def test_format_table_is_the_jax_one():
    rows = {"requests": 1234567, "tokens/s": 3.14159, "ok": True,
            "mode": "paged"}
    assert format_table("Serving metrics:", rows) == jax_format_table(
        "Serving metrics:", rows)
    assert serve_metrics.format_table is format_table


def test_lambda_callback_hooks_and_a_schedule_overwrites_writes():
    seen = []
    tr = Trainer(tiny_llama(vocab_size=VOCAB, max_len=32, device="cpu"),
                 optimizer="sgd", learning_rate=0.1, device="cpu",
                 lr_schedule="constant", **KEYS)
    cb = LambdaCallback(
        on_train_begin=lambda: seen.append("begin"),
        on_train_batch_end=lambda step, logs: (
            seen.append(("batch", step, sorted(logs))),
            set_learning_rate(tr.optimizer, 5.0)),
        on_epoch_end=lambda epoch, logs: seen.append(("epoch", epoch)),
        on_train_end=lambda logs: seen.append("end"))
    tr.fit(SyntheticLanguageModeling(**LM), steps_per_epoch=2, verbose=0,
           callbacks=[cb])
    assert seen == ["begin", ("batch", 0, ["accuracy", "loss"]),
                    ("batch", 1, ["accuracy", "loss"]), ("epoch", 0), "end"]
    # The write after step 1 stands until the next update re-reads the
    # schedule; the JAX trainer does the same.
    assert get_learning_rate(tr.optimizer) == 5.0
    tr.train_step(SyntheticLanguageModeling(**LM).batch(2))
    assert get_learning_rate(tr.optimizer) == pytest.approx(0.1)
    jtr = JaxTrainer(jax_tiny_llama(vocab_size=VOCAB, max_len=32),
                     optimizer="sgd", learning_rate=0.1,
                     lr_schedule="constant", **KEYS)
    jtr.fit(JaxLM(**LM), steps_per_epoch=2, verbose=0)
    assert jax_get_lr(jtr.state) == pytest.approx(0.1)
