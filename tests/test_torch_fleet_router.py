"""The port's fleet router over in-process replicas (`pddl_tpu_torch/
serve/fleet/`), on the CPU: a kill-and-migrate run against the JAX
package's fleet on bridged weights (the same routing, rids, streams and
journal bytes; each package recovers the other's journal), one chaos
campaign with every invariant held, and one hot-standby takeover. The
router, the engines and the lease read fake clocks: nothing here waits
on the wall clock."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeClock
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.serve import FaultKind as JaxFaultKind
from pddl_tpu.serve import FaultPlan as JaxFaultPlan
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.fleet import FleetRouter as JaxFleetRouter
from pddl_tpu.serve.fleet import LocalReplica as JaxLocalReplica
from pddl_tpu.serve.fleet import RouterJournal as JaxRouterJournal
from pddl_tpu_torch.bridge import gpt_params_from_jax
from pddl_tpu_torch.chaos import ChaosConductor, ReplicaChaos, local_kill
from pddl_tpu_torch.models.gpt import generate, tiny_gpt
from pddl_tpu_torch.serve import FaultKind, FaultPlan, ServeEngine
from pddl_tpu_torch.serve.fleet import (
    FleetRouter,
    HotStandby,
    Lease,
    LeaseKeeper,
    LocalReplica,
    RouterJournal,
    WalShipper,
)
from pddl_tpu_torch.serve.fleet import journal as journal_io
from pddl_tpu_torch.serve.request import RequestState
from pddl_tpu_torch.utils.faults import StorageFaultPlan

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V, MAX_LEN, BS = 32, 64, 8
ROUTER_KW = dict(affinity_block_size=BS, affinity_blocks=1, respawn=False)


def _no_sleep(_):
    pass


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_gpt(vocab_size=V, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray, params)))
    return {"jm": jm, "jv": {"params": params}, "tm": tm}


def _oracle(model, prompt, n):
    out = generate(model, np.asarray(prompt, np.int32)[None], n)
    return out[0, len(prompt):].tolist()


def _factory(models, pkg, plan=None, clock=None):
    """The fleet tests' 4-program engine (prefix cache off: routing
    affinity lives in the router's shadow index)."""
    kw = dict(max_slots=2, prefill_len=16, max_queue_depth=64,
              prefix_cache_blocks=0, fault_plan=plan,
              backoff_sleep=_no_sleep)
    if clock is not None:
        kw["clock"] = clock

    def make():
        if pkg == "jax":
            return JaxServeEngine(models["jm"], models["jv"], **kw)
        return ServeEngine(models["tm"], device="cpu", **kw)
    return make


def _workload(n_requests, seed=0):
    """The JAX kill matrix's workload: distinct prompt heads plus a
    shared-prefix pair (every 4th request repeats the previous prompt)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        if i % 4 == 3 and reqs:
            p, _ = reqs[-1]
            reqs.append((p, int(rng.integers(3, 7))))
        else:
            plen = int(rng.integers(6, 15))
            reqs.append((rng.integers(0, V, size=plen).astype(np.int32),
                         int(rng.integers(3, 8))))
    return reqs


PKGS = {
    "jax": dict(router=JaxFleetRouter, replica=JaxLocalReplica,
                plan=JaxFaultPlan, kill=JaxFaultKind.KILL,
                journal=JaxRouterJournal),
    "port": dict(router=FleetRouter, replica=LocalReplica, plan=FaultPlan,
                 kill=FaultKind.KILL, journal=RouterJournal),
}


def _killed_fleet(models, pkg, journal_dir, reqs):
    """Two replicas behind a journaled router on a fake clock: submit,
    let streams start, schedule a KILL on the busiest replica's next
    tick, and step until the death has been handled and the survivors
    have streamed on (the router then 'crashes': it is dropped)."""
    api = PKGS[pkg]
    clock = FakeClock(0.0)
    plans = [api["plan"](sleep_fn=_no_sleep) for _ in range(2)]
    reps = [api["replica"](i, _factory(models, pkg, plans[i], clock))
            for i in range(2)]
    journal = api["journal"](journal_dir, fsync_batch_records=4)
    fleet = api["router"](reps, journal=journal, clock=clock, **ROUTER_KW)
    handles = [fleet.submit(p, n) for p, n in reqs]
    routes = [h.replica_id for h in handles]
    for _ in range(2):
        fleet.step()
    victim = max(fleet.replicas, key=lambda s: s.load)
    eng = victim.driver.engine
    plans[victim.replica_id]._sched[(eng._step_idx, "tick")] = [api["kill"]]
    steps = 0
    while fleet.metrics.replica_down_events == 0 and steps < 50:
        fleet.step()
        steps += 1
    for _ in range(3):
        fleet.step()
    journal.commit()
    return dict(fleet=fleet, handles=handles, routes=routes,
                victim=victim.replica_id, journal=journal)


def test_kill_and_migrate_matches_jax_fleet_and_journals_cross_recover(
        models, tmp_path):
    """The JAX package's kill matrix (N 2, seed 0) on both packages: the
    same routing decisions and rids, the same victim and migration
    counts, token-equal streams and byte-identical journals at the
    crash; then each package's router recovers the OTHER package's
    journal over fresh replicas and finishes every stream token-exact."""
    reqs = _workload(6, seed=0)
    runs = {pkg: _killed_fleet(models, pkg, str(tmp_path / pkg), reqs)
            for pkg in PKGS}
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["routes"] == jax_run["routes"]
    assert len(set(port_run["routes"])) == 2
    assert port_run["victim"] == jax_run["victim"]
    assert sorted(port_run["fleet"]._by_rid) == \
        sorted(jax_run["fleet"]._by_rid)
    for key in ("replica_down_events", "requests_migrated",
                "migrated_via_drain", "migrated_via_replay"):
        assert getattr(port_run["fleet"].metrics, key) == \
            getattr(jax_run["fleet"].metrics, key), key
    assert port_run["fleet"].metrics.migrated_via_drain >= 1
    assert [h.tokens for h in port_run["handles"]] == \
        [h.tokens for h in jax_run["handles"]]
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    for run in runs.values():
        run["journal"].close()
    refs = [_oracle(models["tm"], p, n) for p, n in reqs]
    by_prompt = {tuple(int(t) for t in p): r for (p, _), r in zip(reqs, refs)}
    recovered = {}
    for pkg, other in (("port", "jax"), ("jax", "port")):
        api = PKGS[pkg]
        fresh = [api["replica"](i, _factory(models, pkg)) for i in range(2)]
        router, revived = api["router"].recover(
            str(tmp_path / other), fresh, clock=FakeClock(0.0), **ROUTER_KW)
        recovered[pkg] = {rid: (list(fh.request.prompt), list(fh.tokens))
                          for rid, fh in revived.items()}
        router.run(max_steps=400)
        for rid, fh in revived.items():
            assert fh.state.value == RequestState.FINISHED.value, rid
            assert fh.tokens == by_prompt[tuple(fh.request.prompt)], rid
        router.close()
    assert recovered["port"] == recovered["jax"] and recovered["port"]
    assert journal_io.read_state(str(tmp_path / "port")) == \
        journal_io.read_state(str(tmp_path / "jax"))
    # The survivors of the port run served every stream on one census.
    survivor = next(s for s in port_run["fleet"].replicas
                    if s.replica_id != port_run["victim"])
    assert set(survivor.driver.engine.compile_counts().values()) == {1}


def test_conductor_campaign_all_invariants_hold(models, tmp_path):
    """The JAX package's unified campaign (seed 0) on the port: a storage
    storm, a seeded hard kill and a router crash composed over a
    2-replica fleet; every referee invariant holds (the recovery bound
    is generous: the campaign is judged on its invariants)."""
    plans = {}
    state = {"base": 0}

    def make_replicas():
        base, state["base"] = state["base"], state["base"] + 10
        reps = []
        for k in range(2):
            plan = FaultPlan(sleep_fn=_no_sleep)
            plans[base + k] = plan
            reps.append(LocalReplica(base + k, _factory(models, "port",
                                                        plan)))
        return reps

    def make_chaos(fleet):
        return [ReplicaChaos(
                    replica_id=int(s.replica_id),
                    plan=plans[int(s.replica_id)],
                    kill_fn=(lambda p=plans[int(s.replica_id)]:
                             local_kill(p)))
                for s in fleet.replicas]

    seed = 0
    rng = np.random.default_rng(100 + seed)
    reqs, seen = [], set()
    while len(reqs) < 5:
        p = rng.integers(0, V, size=int(rng.integers(8, 13))).astype(
            np.int32)
        if tuple(p) not in seen:
            seen.add(tuple(p))
            reqs.append((p, 8))
    cond = ChaosConductor(
        make_replicas, make_chaos,
        lambda p, n: _oracle(models["tm"], p, n),
        journal_dir=str(tmp_path / "wal"),
        storage_plan=StorageFaultPlan(seed=seed),
        router_kw=dict(ROUTER_KW),
        journal_kw=dict(fsync_batch_records=2, retry_limit=1,
                        retry_backoff_s=0.0, rearm_interval_s=0.0,
                        sleep_fn=_no_sleep),
        recovery_bound_s=600.0, seed=seed)
    report = cond.run(reqs, planes=("device", "storage", "kill", "router"),
                      horizon=30, kills=1, max_wall_s=600.0)
    assert report.ok, report.violations
    assert {"storm_on", "kill", "router_crash"} <= \
        {a.kind for a in report.actions}
    assert report.injected.get("storage", 0) >= 1
    assert all(report.invariants.values()), report.invariants


def test_hot_standby_takeover_token_exact(models, tmp_path):
    """The primary serves partway under a lease, its lease lapses, and
    the hot standby (fed the primary's WAL through the shipper) promotes
    over the same live replicas under a bumped epoch: every acked open
    stream finishes token-exact, on one census."""
    d = str(tmp_path / "wal")
    journal = RouterJournal(d, fsync_batch_records=4)
    replicas = [LocalReplica(i, _factory(models, "port")) for i in range(2)]
    fleet = FleetRouter(replicas, journal=journal, **ROUTER_KW)
    clock = FakeClock(0.0)
    lease = Lease(str(tmp_path / "ha_lease.json"), ttl_s=1.0, clock=clock)
    keeper = LeaseKeeper(lease, "primary", seed=0)
    fleet.set_epoch(keeper.acquire())
    fleet.ha = keeper
    standby = HotStandby(d, [s.driver for s in fleet.replicas], lease=lease,
                         holder="standby", seed=1,
                         router_kw=dict(ROUTER_KW))
    standby.attach(WalShipper(journal, standby.feed))
    assert fleet.epoch == 1
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, V, size=int(rng.integers(6, 15))).astype(
        np.int32), int(rng.integers(3, 8))) for _ in range(6)]
    refs = {tuple(int(t) for t in p): _oracle(models["tm"], p, n)
            for p, n in reqs}
    handles = [fleet.submit(p, n) for p, n in reqs]
    for _ in range(4):
        fleet.step()
        keeper.step()
    acked = {tuple(int(t) for t in h.request.prompt): list(h.tokens)
             for h in handles}
    clock.now = 5.0  # the lease lapses un-renewed
    out = standby.step()
    assert out is not None and standby.promoted
    router, revived = out
    assert standby.step() is None
    assert router.epoch == 2 and lease.read()["holder"] == "standby"
    assert keeper.step() is False
    router.run(max_steps=4000)
    assert router.metrics.takeovers == 1
    open_keys = {k for k, t in acked.items() if len(t) < len(refs[k])}
    revived_keys = set()
    for fh in revived.values():
        key = tuple(int(t) for t in fh.request.prompt)
        revived_keys.add(key)
        assert fh.state == RequestState.FINISHED
        assert fh.tokens == refs[key]
    assert open_keys and open_keys <= revived_keys
    assert journal_io.load_checkpoint(d) is not None
    for s in router.replicas:
        assert set(s.driver.engine.compile_counts().values()) == {1}
    router.close()
