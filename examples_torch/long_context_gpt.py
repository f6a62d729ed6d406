"""Long-context causal LM: train with remat, then sample with a KV cache.

The port of ``examples/long_context_gpt.py``: a GPT with activation
rematerialization ("dots": recompute elementwise, keep matmuls), a cosine
LR schedule, perplexity tracking, and top-k/nucleus sampling from the
trained model with an explicit ``torch.Generator``.

    python examples_torch/long_context_gpt.py [--device cpu]

Runs on the card unless ``--device cpu``; without a card it raises.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling  # noqa: E402
from pddl_tpu_torch.device import resolve_device  # noqa: E402
from pddl_tpu_torch.models.gpt import generate, tiny_gpt  # noqa: E402
from pddl_tpu_torch.train import Trainer  # noqa: E402

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
device = resolve_device(p.parse_args().device)

data = SyntheticLanguageModeling(batch_size=32, seq_len=64, vocab_size=32)
model = tiny_gpt(vocab_size=32, max_len=128, remat="dots", device=device)

trainer = Trainer(
    model, optimizer="adamw", learning_rate=3e-3,
    lr_schedule="cosine", lr_schedule_options={"decay_steps": 48},
    metrics=["accuracy", "perplexity"],
    input_key="tokens", target_key="targets", device=device,
)
trainer.fit(data, epochs=6, steps_per_epoch=8, verbose=2)

prompt = torch.as_tensor(data.batch(0)["tokens"][:2, :8], device=device)
out = generate(
    model.eval(), prompt, max_new_tokens=16, temperature=0.7, top_k=8,
    top_p=0.95, generator=torch.Generator(device=device).manual_seed(0),
)
print("sampled continuation:", out[:, 8:].tolist())
