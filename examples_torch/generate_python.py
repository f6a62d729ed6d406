"""Train a byte-level GPT on real Python source, then sample from it.

The port of ``examples/generate_python.py``: build the CPython-stdlib
corpus (``real_data_convergence.py``'s recipe), train GPT-Small at full
width (768 x 12, bf16 compute, ``attention="flash"``) for a few thousand
steps on the card, then sample continuations of Python-looking prompts
with the KV-cache sampler (temperature 0.8, nucleus 0.95) from an
explicit ``torch.Generator``. Samples are written next to the port's
convergence artifacts.

    python examples_torch/generate_python.py
    python examples_torch/generate_python.py --speculative

With ``--speculative`` the samples come from ``generate_speculative``
(prompt-lookup drafts), and the file records its acceptance rate on the
trained weights, under sampling and under greedy decoding (where its
tokens are also held against ``generate()``'s). Runs on the card unless
``--device cpu``; without a card it raises. ``PDDL_EXAMPLE_SMOKE=1``:
a tiny model, a handful of steps, samples in the work dir.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from examples_torch.real_data_convergence import (  # noqa: E402
    ARTIFACTS,
    WORK_DIR,
    _build_atomically,
    build_python_corpus,
    device_label,
)

SMOKE = bool(os.environ.get("PDDL_EXAMPLE_SMOKE"))

# Equal byte lengths: one batched generate() call decodes all four.
PROMPTS = (
    b"def get_",
    b"class My",
    b"import o",
    b"    for ",
)
DRAFT_LEN = 7  # generate_speculative's default window is DRAFT_LEN + 1


def acceptance_rate(stats: dict, draft_len: int = DRAFT_LEN) -> float:
    """Drafts accepted over drafts proposed: a tick emits its accepted
    drafts plus one token of its own, after the prefill's first token."""
    accepted = stats["emitted"] - 1 - stats["ticks"]
    return accepted / max(1, stats["ticks"] * draft_len)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card (default; raises without one) or the "
                        "host's plain PyTorch paths")
    p.add_argument("--work-dir", default=WORK_DIR)
    p.add_argument("--steps", type=int, default=30 if SMOKE else 3000)
    p.add_argument("--max-new", type=int, default=16 if SMOKE else 256)
    p.add_argument("--speculative", action="store_true",
                   help="sample via speculative (prompt-lookup) "
                        "decoding -- same distribution, fewer ticks")
    p.add_argument("--out", default=None,
                   help="samples file (default: the committed artifacts "
                        "dir; the work dir in smoke mode)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from pddl_tpu_torch.data.text import load_token_corpus
    from pddl_tpu_torch.device import resolve_device
    from pddl_tpu_torch.models.gpt import GPT, generate
    from pddl_tpu_torch.train.loop import Trainer

    device = resolve_device(args.device)
    if args.out is None:
        name = ("pycorpus_samples_speculative.txt" if args.speculative
                else "pycorpus_samples.txt")
        args.out = os.path.join(args.work_dir if SMOKE else ARTIFACTS, name)

    data_dir = os.path.join(args.work_dir, "pycorpus")
    _build_atomically(data_dir, build_python_corpus)

    seq_len = 64 if SMOKE else 256
    batch = 8 if SMOKE else 32
    train_ds, _ = load_token_corpus(
        data_dir, seq_len=seq_len, train_batch_size=batch,
        val_batch_size=batch, seed=0)

    model = GPT(
        vocab_size=256, max_len=max(seq_len, 512 if not SMOKE else seq_len),
        embed_dim=32 if SMOKE else 768, depth=2 if SMOKE else 12,
        num_heads=2 if SMOKE else 12,
        attention="reference" if SMOKE else "flash",
        dtype=torch.bfloat16 if not SMOKE else torch.float32,
        param_dtype=torch.float32, device=device, seed=0,
    )
    trainer = Trainer(
        model, optimizer="adamw", learning_rate=3e-4,
        input_key="tokens", target_key="targets",
        lr_schedule="cosine",
        lr_schedule_options={"decay_steps": args.steps, "warmup_steps":
                             max(2, args.steps // 30)},
        metrics=["accuracy", "perplexity"], device=device, seed=0,
    )
    t0 = time.time()
    epochs = max(1, args.steps // 300)
    spe = args.steps // epochs
    hist = trainer.fit(train_ds, epochs=epochs, steps_per_epoch=spe,
                       verbose=0)
    train_s = time.time() - t0
    final_loss = hist.history["loss"][-1]
    print(f"trained {epochs * spe} steps in {train_s:.0f}s, "
          f"final loss {final_loss:.3f} nats/byte", file=sys.stderr)

    model.eval()
    prompts = torch.as_tensor(np.stack([
        np.frombuffer(p, np.uint8).astype(np.int32) for p in PROMPTS
    ]), device=device)

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    stats = {}
    t0 = time.time()
    with torch.no_grad():
        if args.speculative:
            from pddl_tpu_torch.models.speculative import generate_speculative

            out, s = generate_speculative(
                model, prompts, args.max_new, temperature=0.8, top_p=0.95,
                generator=gen(), draft_len=DRAFT_LEN, return_stats=True)
            stats["sampling"] = dict(s, acceptance_rate=acceptance_rate(s))
            print(f"speculative sampling: {s['tokens_per_tick']:.2f} "
                  f"tokens/tick over {s['ticks']} ticks, acceptance "
                  f"{stats['sampling']['acceptance_rate']:.4f}",
                  file=sys.stderr)
            greedy, g = generate_speculative(
                model, prompts, args.max_new, draft_len=DRAFT_LEN,
                return_stats=True)
            plain = generate(model, prompts, args.max_new)
            stats["greedy"] = dict(
                g, acceptance_rate=acceptance_rate(g),
                rows_equal_to_generate=int(
                    (greedy == plain).all(dim=1).sum()))
        else:
            out = generate(model, prompts, args.max_new, temperature=0.8,
                           top_p=0.95, generator=gen())
    out = out.cpu().numpy()
    gen_s = time.time() - t0
    n_tok = len(PROMPTS) * args.max_new

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    record = {"steps": epochs * spe, "train_seconds": round(train_s, 1),
              "final_train_loss_nats": round(float(final_loss), 5),
              "new_tokens": n_tok, "generate_seconds": round(gen_s, 2),
              "speculative": stats or None, "device": device_label(device)}
    with open(args.out, "w") as f:
        f.write(f"# GPT samples after {epochs * spe} steps on the CPython "
                f"corpus (temperature 0.8, top-p 0.95, seed 0"
                f"{', speculative' if args.speculative else ''}; "
                f"{gen_s:.1f}s for {n_tok} tokens)\n")
        f.write(f"# {json.dumps(record)}\n")
        for row in out:
            text = bytes(row.astype(np.uint8)).decode(
                "utf-8", errors="replace")
            f.write("\n" + "-" * 60 + "\n" + text + "\n")
            print("-" * 60 + "\n" + text, file=sys.stderr)
    print(json.dumps(record))
    print(f"samples -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
