"""One mesh, every axis: DP x TP training, then sharded decoding.

The port of ``examples/shard_everything.py``: four processes form a
``data`` 2 x ``model`` 2 mesh (Megatron tensor parallelism inside data
parallelism), train a GPT together, then decode with the same strategy:
the weights stay in the Megatron layout and the KV cache splits by head
over ``model``.

    python examples_torch/shard_everything.py [--device cpu]

The script launches its four processes itself, joined over gloo on
localhost (on the card they share it, as two or four processes of one
host do). The processes have one deadline; any that survive it are
killed. Runs on the card unless ``--device cpu``; without a card it
raises.
"""

import argparse
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 4
DEADLINE_S = 600.0


def worker(rank: int, port: int, device: str) -> None:
    import torch

    from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
    from pddl_tpu_torch.models.gpt import generate, tiny_gpt
    from pddl_tpu_torch.parallel import TensorParallelStrategy
    from pddl_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=WORLD,
        rank=rank)
    dev = torch.device(device if device == "cpu" else "cuda:0")
    # data axis = processes / 2, model axis = 2: Megatron TP inside DP.
    strategy = TensorParallelStrategy(model_parallel=2, device=dev,
                                      backend="gloo")
    data = SyntheticLanguageModeling(batch_size=32, seq_len=32,
                                     vocab_size=16)
    model = tiny_gpt(vocab_size=16, max_len=64, device=dev)

    trainer = Trainer(model, optimizer="adamw", learning_rate=3e-3,
                      strategy=strategy, input_key="tokens",
                      target_key="targets")
    trainer.fit(data, epochs=4, steps_per_epoch=8,
                verbose=2 if rank == 0 else 0)

    prompt = torch.as_tensor(data.batch(0)["tokens"][:2, :8], device=dev)
    out = generate(model.eval(), prompt, max_new_tokens=8,
                   strategy=strategy)
    if rank == 0:
        print("sharded generation:", out[:, 8:].tolist(), flush=True)
    torch.distributed.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--worker", nargs=2, type=int, metavar=("RANK", "PORT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        worker(*args.worker, args.device)
        return 0
    from pddl_tpu_torch.device import resolve_device

    resolve_device(args.device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", args.device,
         "--worker", str(rank), str(port)], env=env)
        for rank in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for proc in procs:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        print(f"shard_everything: past the {DEADLINE_S:.0f} s deadline",
              file=sys.stderr)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [(rank, proc.returncode) for rank, proc in enumerate(procs)
           if proc.returncode != 0]
    if bad:
        print(f"shard_everything: processes exited {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
