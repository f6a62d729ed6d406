"""The port's fleet worker as a real OS process
(`pddl_tpu_torch/serve/fleet/worker.py`), on the CPU: the JAX package's
`ProcessReplica` drives it through the JAX driver (the protocol is the
same on both sides of the pipe), and a fleet of two port workers loses
one to SIGKILL mid-stream and still finishes every stream token-exact.
Each test kills its surviving workers when it ends or when its deadline
passes."""

import json
import sys
import time

import numpy as np
import pytest

from pddl_tpu.serve.fleet import EpochFenced as JaxEpochFenced
from pddl_tpu.serve.fleet import ProcessReplica as JaxProcessReplica
from pddl_tpu.serve.request import SamplingParams as JaxSampling
from pddl_tpu_torch.serve.fleet import FleetRouter, ProcessReplica
from pddl_tpu_torch.serve.fleet.replica import snapshot_from_pairs
from pddl_tpu_torch.serve.fleet.worker import FENCED_CMDS, ROLES, build_engine
from pddl_tpu_torch.serve.request import RequestState

CFG = dict(vocab=32, max_len=64, embed_dim=32, depth=2, heads=4, slots=2,
           prefill_len=16, max_queue_depth=64, param_seed=0,
           prefix_cache_blocks=0, device="cpu")
DEADLINE_S = 120.0


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    # Each worker process runs its engine on one host thread.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


class _PortWorker(JaxProcessReplica):
    """The JAX driver, spawning the port's worker through the driver's
    own command-line seam."""

    def _worker_argv(self):
        return [self._python, "-m", "pddl_tpu_torch.serve.fleet.worker",
                "--config-json", json.dumps(self._config)]


def _oracle(prompt, n):
    eng = build_engine(CFG)
    h = eng.submit(prompt, n)
    eng.run(max_steps=200)
    return list(h.tokens)


def _pump(rep, streams, finished, until, deadline):
    while not until() and time.monotonic() < deadline:
        for ev in rep.step():
            if ev.get("ev") == "tokens":
                for rid, toks in ev["toks"]:
                    streams.setdefault(int(rid), []).extend(toks)
            elif ev.get("ev") == "finish":
                finished[int(ev["rid"])] = ev
        time.sleep(0.002)
    assert until(), "worker did not answer before the deadline"


def test_jax_process_replica_drives_the_port_worker():
    """Ready with the census all 1, submit/tokens/finish token-exact
    against an in-process port engine, counts, the fencing epoch (a
    stale command refused), then a SIGTERM drain mid-stream whose
    snapshot restores in-process and finishes the stream exactly."""
    from pddl_tpu_torch.serve.fleet.replica import EPOCH_CMDS
    from pddl_tpu_torch.serve.fleet.disagg import ROLES as DISAGG_ROLES

    assert FENCED_CMDS == EPOCH_CMDS and set(ROLES) == set(DISAGG_ROLES)
    deadline = time.monotonic() + DEADLINE_S
    rep = _PortWorker(0, {**CFG, "replica_id": 0}, python=sys.executable,
                      ready_timeout_s=DEADLINE_S)
    try:
        want_keys = set(build_engine(CFG).compile_counts())
        assert set(rep.ready_compile_counts) == want_keys
        assert set(rep.ready_compile_counts.values()) == {1}
        assert rep.fence(3) == 3
        with pytest.raises(JaxEpochFenced):
            rep.submit(99, [1, 2], 2, JaxSampling(), None, epoch=2)
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        streams, finished = {}, {}
        rep.submit(1, prompt, 6, JaxSampling(), None, epoch=3)
        _pump(rep, streams, finished, lambda: 1 in finished, deadline)
        assert finished[1]["reason"] == "length"
        assert streams[1] == _oracle(prompt, 6)
        long_prompt = list(range(2, 12))
        rep.submit(2, long_prompt, 40, JaxSampling(), None, epoch=3)
        _pump(rep, streams, finished, lambda: len(streams.get(2, ())) >= 3,
              deadline)
        assert set(rep.compile_counts().values()) == {1}
        entries = rep.drain_entries(0.0)
        for ev in rep.take_pending():
            if ev.get("ev") == "tokens":
                for rid, toks in ev["toks"]:
                    streams.setdefault(int(rid), []).extend(toks)
        assert [rid for rid, _ in entries] == [2]
        entry = entries[0][1]
        assert entry["tokens"] == streams[2] and 3 <= len(streams[2]) < 40
        assert rep._proc.wait(timeout=30) == 0
        eng = build_engine(CFG)
        (h,) = eng.restore(snapshot_from_pairs(entries))
        eng.run(max_steps=200)
        assert h.tokens == _oracle(long_prompt, 40)
    finally:
        rep.kill()
        rep.close()


def test_port_process_fleet_sigkill_mid_stream_token_exact():
    """Two port workers behind the port's router; one is SIGKILLed
    mid-stream, so its streams migrate off the router's mirrors (no
    drain possible) and every stream still finishes token-exact against
    an in-process engine with the same ``param_seed``; the survivor's
    census stays at 1."""
    reps = [ProcessReplica(i, {**CFG, "replica_id": i},
                           python=sys.executable, wait_ready=False,
                           ready_timeout_s=DEADLINE_S) for i in range(2)]
    try:
        for rep in reps:
            rep.wait_ready()
        fleet = FleetRouter(reps, affinity_block_size=8, affinity_blocks=1,
                            respawn=False)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 32, size=12).tolist() for _ in range(6)]
        handles = [fleet.submit(p, 12) for p in prompts]
        assert len({h.replica_id for h in handles}) == 2
        deadline = time.monotonic() + DEADLINE_S
        while sum(len(h.tokens) for h in handles) < 12 \
                and time.monotonic() < deadline:
            fleet.step()
        victim = next(s for s in fleet.replicas
                      if s.replica_id == handles[0].replica_id)
        assert victim.load > 0
        victim.driver.kill()  # SIGKILL: no drain possible
        while fleet.has_work and time.monotonic() < deadline:
            fleet.step()
            time.sleep(0.001)
        assert not fleet.has_work, "the fleet did not finish in time"
        eng = build_engine(CFG)
        for p, h in zip(prompts, handles):
            assert h.state == RequestState.FINISHED
            ref = eng.submit(p, 12)
            eng.run(max_steps=200)
            assert h.tokens == ref.tokens
        assert fleet.metrics.replica_down_events == 1
        assert fleet.metrics.migrated_via_replay >= 1
        assert fleet.metrics.migrated_via_drain == 0
        survivor = next(s for s in fleet.replicas if s is not victim)
        assert set(survivor.driver.compile_counts().values()) == {1}
    finally:
        for rep in reps:
            rep.kill()
            rep.close()
