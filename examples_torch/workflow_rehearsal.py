"""Full-resolution reference-workflow rehearsal of the PyTorch port.

The port of ``examples/workflow_rehearsal.py``. The reference is a
workflow: train ResNet-50 at 224px with val-loss-driven callbacks,
checkpoint, survive interruption, and ``model.save`` at the end
(``/root/reference/imagenet-resnet50.py:64-72``). This driver runs that
story through the port's command line (one ``python -m pddl_tpu_torch``
process per leg, what a user types) and checks every seam:

1. ``single`` preset, synthetic 224x224 data, ResNet-50, enough epochs
   that the reference's own callbacks fire (plateau patience 5 →
   ReduceLROnPlateau; early-stop patience 10 on a plateauing val loss).
2. A SIGTERM once the epoch marker shows (a preemption) → the
   PreemptionCheckpoint handler writes a consistent checkpoint and the
   process exits cleanly.
3. Relaunch with ``--resume`` → continues from the interrupted epoch,
   runs to the early stop, exports the final artifact.
4. The artifact re-imports (``.h5`` through the Keras-layout mapper, or
   the ``.npz`` of the state dict) and its logits equal the checkpoint's
   bit for bit.

Proof obligations, read from the artifacts: the resumed leg's last epoch
is below the budget (early stop fired), the checkpoint's learning rate
ends below the initial 1e-3 (plateau fired), and a logit delta of 0.

    python examples_torch/workflow_rehearsal.py --final-format npz

``.h5`` needs h5py; ``--final-format`` picks the form (``.h5`` at full
size and ``.npz`` in smoke mode by default). Runs on the card unless
``--device cpu``; without a card it raises. Writes ``rehearsal_log.txt``
(every leg's output) and ``workflow_rehearsal.json`` (the measured
values) under ``artifacts/workflow_rehearsal_torch``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ARTIFACTS = os.path.join(REPO, "artifacts", "workflow_rehearsal_torch")

# Smoke mode (PDDL_EXAMPLE_SMOKE=1): the same four-leg workflow at toy
# scale on the host, a tiny model and an .npz final artifact, so the
# script's seams stay covered in the suite while the committed artifact
# comes from the full-resolution card run.
SMOKE = bool(os.environ.get("PDDL_EXAMPLE_SMOKE"))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One rehearsal's scale."""

    model: str
    image: int
    batch: int
    num_classes: int
    epochs: int
    steps: int
    # The epoch whose end-of-epoch line starts the SIGTERM (the port
    # prints "Epoch k/N" when epoch k ends), and the cap on waiting for it.
    marker_epoch: int
    sigterm_after: float
    lr: Optional[float] = None


# The epoch budget leaves slack past the early-stop point: the stop must
# come from the callback, not the budget. 50 full-res steps an epoch, not
# fewer: BatchNorm moving statistics (at momentum 0.9) need a few hundred
# updates before inference-mode val metrics mean anything. Few classes:
# the synthetic class-mean task converges in a few epochs and then
# plateaus, which is what makes the reference's val-loss callbacks fire
# inside the budget.
FULL = Plan(model="resnet50", image=224, batch=32, num_classes=16,
            epochs=40, steps=50, marker_epoch=2, sigterm_after=600)
# Smoke: 3x the reference LR so the tiny model reaches its val floor
# inside the budget; 8 steps an epoch (the JAX smoke plan's 16) stop
# early by epoch ~41 with the LR cut twice, in two-thirds of the time.
SMOKE_PLAN = Plan(model="tiny_resnet", image=32, batch=8, num_classes=8,
                  epochs=56, steps=8, marker_epoch=1, sigterm_after=120,
                  lr=3e-3)


def cli(plan: Plan, workdir: str, final: str, device: str, *extra) -> list:
    return [
        sys.executable, "-m", "pddl_tpu_torch",
        "--preset", "single", "--synthetic", "--model", plan.model,
        "--image-size", str(plan.image), "--batch", str(plan.batch),
        "--num-classes", str(plan.num_classes),
        # Strong class separation: at the default (weak) signal the
        # replayed finite epoch lets ResNet-50 memorize instead of
        # generalize, and the val-loss callbacks fire on BN-settling noise.
        "--synthetic-signal", "10.0",
        # BN momentum 0.9 (not the Keras-parity 0.99): inference-mode val
        # metrics read the moving averages, which at 0.99 stay
        # half-initialized for longer than these synthetic epochs.
        "--bn-momentum", "0.9",
        *(["--lr", str(plan.lr)] if plan.lr is not None else []),
        "--epochs", str(plan.epochs), "--steps-per-epoch", str(plan.steps),
        "--checkpoint-dir", os.path.join(workdir, "ckpt"),
        "--save", os.path.join(workdir, final),
        "--seed", "0", "--verbose", "2", "--device", device, *extra,
    ]


def _read_from(path: str, start: int) -> str:
    with open(path) as f:
        return f.read()[start:]


def _epochs(text: str, epochs: int) -> List[int]:
    return sorted(set(int(m) for m in re.findall(
        r"Epoch (\d+)/%d" % epochs, text)))


def _logits_delta(plan: Plan, device: str, ckpt_dir: str, final: str):
    """Leg 4: ``(final_lr, logits_delta, params_delta)`` between the
    newest checkpoint and the exported artifact, both loaded into a
    fresh model of the plan's architecture on ``device``."""
    import numpy as np
    import torch

    from pddl_tpu_torch.ckpt.checkpoint import Checkpointer
    from pddl_tpu_torch.models.registry import get_model

    state, _ = Checkpointer(ckpt_dir, async_save=False,
                            read_only=True).restore()
    # The learning rate in the final checkpoint proves ReduceLROnPlateau
    # fired (0.1x a firing from the preset's 1e-3).
    final_lr = float(state["optimizer"]["param_groups"][0]["lr"])

    # One model of the plan's architecture, loaded from the artifact and
    # then from the checkpoint, on the same input.
    model = get_model(plan.model, num_classes=plan.num_classes,
                      device=device, bn_momentum=0.9).eval()
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2, plan.image, plan.image, 3, generator=gen).to(device)
    sd = state["model"]
    params_delta = None
    if final.endswith(".h5"):
        from pddl_tpu_torch.ckpt.keras_import import load_keras_resnet50_h5

        load_keras_resnet50_h5(final, model, require_head=True)
    else:
        with np.load(final) as z:
            missing = sorted(set(sd) - set(z.files))
            if missing:
                raise KeyError(f"{final} lacks {missing[:5]}")
            params_delta = max(float(np.max(np.abs(
                z[k] - sd[k].float().numpy()))) if sd[k].numel() else 0.0
                for k in sd)
            model.load_state_dict({
                k: torch.as_tensor(z[k]).to(sd[k].dtype) for k in sd})
    with torch.no_grad():
        from_file = model(x, train=False)
        model.load_state_dict(sd)
        delta = float((from_file - model(x, train=False)).abs().max())
    return final_lr, delta, params_delta


def rehearse(plan: Plan, work_dir: str, artifacts_dir: str,
             device: str = "cuda", final_format: str = "h5") -> dict:
    """Run the four legs and return the measured record (every leg's exit
    code, wall and epochs, the checkpoint's steps and learning rate, the
    artifact's logit delta). Raises when a seam is missing: no preemption,
    no checkpoint, no artifact."""
    from pddl_tpu_torch.device import resolve_device

    device = str(resolve_device(device))
    os.makedirs(artifacts_dir, exist_ok=True)
    os.makedirs(work_dir, exist_ok=True)
    final_name = f"final.{final_format}"
    log_path = os.path.join(artifacts_dir, "rehearsal_log.txt")
    log = open(log_path, "w")

    def leg(title, cmd, sigterm_after=None):
        log.write(f"\n===== {title}: {' '.join(cmd)} =====\n")
        log.flush()
        start = len(_read_from(log_path, 0))
        t0 = time.time()
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        interrupted = None
        try:
            if sigterm_after is not None:
                # Signal once training is demonstrably underway (the
                # marker epoch has ended), not after a fixed sleep;
                # sigterm_after caps the wait.
                marker = f"Epoch {plan.marker_epoch}/{plan.epochs}"
                deadline = time.time() + sigterm_after
                while time.time() < deadline and proc.poll() is None:
                    if marker in _read_from(log_path, start):
                        break
                    time.sleep(0.2)
                # The signal exercises the preemption path only if the
                # run is still alive: recorded so the caller can assert it.
                interrupted = proc.poll() is None
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=3600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        dt = time.time() - t0
        log.write(f"===== {title}: rc={rc} wall={dt:.1f}s "
                  f"interrupted={interrupted} =====\n")
        log.flush()
        text = _read_from(log_path, start)
        return {"rc": rc, "wall_s": round(dt, 1),
                "epochs_seen": _epochs(text, plan.epochs)}, interrupted

    try:
        # Leg 1: a fresh run, preempted mid-training by a real SIGTERM.
        leg1, interrupted = leg(
            "leg1-preempted", cli(plan, work_dir, final_name, device),
            sigterm_after=plan.sigterm_after)
        if not interrupted:
            raise RuntimeError(
                f"leg1 finished before the SIGTERM (rc={leg1['rc']}): the "
                "preemption path was never exercised")
        ckpt_dir = os.path.join(work_dir, "ckpt")
        steps_saved = sorted(
            int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
        if not steps_saved:
            raise RuntimeError(
                f"no checkpoint written by preemption (rc={leg1['rc']})")
        leg1["checkpoint_steps"] = steps_saved

        # Leg 2: resume from the preemption checkpoint and run to the end
        # (the early stop should end it before the budget).
        leg2, _ = leg("leg2-resume",
                      cli(plan, work_dir, final_name, device, "--resume"))
    finally:
        log.close()
    final = os.path.join(work_dir, final_name)
    if leg2["rc"] != 0:
        raise RuntimeError(f"resume leg failed rc={leg2['rc']} "
                           f"(see {log_path})")
    if not os.path.exists(final):
        raise RuntimeError("the final model artifact was not exported")

    # Leg 4: the artifact against the checkpoint.
    t0 = time.time()
    final_lr, delta, params_delta = _logits_delta(plan, device, ckpt_dir,
                                                  final)
    leg4_s = time.time() - t0
    epochs2 = leg2["epochs_seen"]
    from examples_torch.real_data_convergence import device_label

    return {
        "metric": "workflow_rehearsal",
        "config": {"preset": "single", **dataclasses.asdict(plan),
                   "final_format": final_format, "smoke": SMOKE},
        "leg1_preempted": leg1,
        "leg2_resume": leg2,
        "leg4_reimport": {"wall_s": round(leg4_s, 1), "artifact": final_name},
        # The resumed leg continues the epoch the SIGTERM interrupted: the
        # one after leg 1's last finished epoch.
        "resumed_at_interrupted_epoch": bool(
            leg1["epochs_seen"] and epochs2
            and epochs2[0] == leg1["epochs_seen"][-1] + 1),
        "early_stopping_fired": bool(epochs2) and max(epochs2) < plan.epochs,
        "reduce_lr_fired": final_lr < 1e-3 * 0.99,
        "final_lr": final_lr,
        "final_vs_checkpoint_max_logit_delta": delta,
        "npz_vs_checkpoint_max_param_delta": params_delta,
        "device": device_label(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card (default; raises without one) or the "
                        "host's plain PyTorch paths")
    p.add_argument("--final-format", choices=("h5", "npz"),
                   default="npz" if SMOKE else "h5",
                   help="the exported artifact: the Keras-layout .h5 "
                        "(needs h5py) or the state dict's .npz")
    p.add_argument("--artifacts-dir", default=ARTIFACTS)
    p.add_argument("--work-dir",
                   default=os.path.join(REPO, "build", "workflow_rehearsal"
                                        + ("_smoke" if SMOKE else "")))
    args = p.parse_args(argv)
    plan = SMOKE_PLAN if SMOKE else FULL
    record = rehearse(plan, args.work_dir, args.artifacts_dir,
                      device=args.device, final_format=args.final_format)
    out = os.path.join(args.artifacts_dir, "workflow_rehearsal.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record, indent=1))
    # Both val-loss callbacks firing is a full-resolution obligation. The
    # smoke run's job is the mechanism (command line, preemption, resume,
    # export) and that the callbacks demonstrably drove the run, so it
    # requires at least one of them: which one fires first on a slowly
    # flattening toy loss depends on where the interrupt landed.
    fired = ((record["early_stopping_fired"] or record["reduce_lr_fired"])
             if SMOKE else (record["early_stopping_fired"]
                            and record["reduce_lr_fired"]))
    ok = (record["final_vs_checkpoint_max_logit_delta"] == 0.0
          and record["leg1_preempted"]["rc"] == 0
          and record["resumed_at_interrupted_epoch"] and fired)
    print("REHEARSAL", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
