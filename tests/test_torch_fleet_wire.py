"""The fleet's wire formats, port against the JAX package (no engines):
the framed transport (`serve/fleet/transport.py`), the router journal
(`serve/fleet/journal.py`), the prefix-chain wire entry
(`serve/drain.py`) and the storage fault plan the journal injects
through. The same records make the same bytes in both packages, and
each package reads what the other wrote."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import pddl_tpu.serve.drain as jax_drain
import pddl_tpu.serve.fleet.journal as jax_journal
import pddl_tpu.serve.fleet.transport as jax_transport
from pddl_tpu.serve.request import Priority as JaxPriority
from pddl_tpu.serve.request import Request as JaxRequest
from pddl_tpu.serve.request import SamplingParams as JaxSampling
from pddl_tpu.utils.faults import StorageFaultKind as JaxStorageKind
from pddl_tpu.utils.faults import StorageFaultPlan as JaxStoragePlan
from pddl_tpu.utils.faults import StorageFaultSpec as JaxStorageSpec
from pddl_tpu_torch.serve import drain as drain_io
from pddl_tpu_torch.serve.fleet import journal as journal_io
from pddl_tpu_torch.serve.fleet import transport
from pddl_tpu_torch.serve.request import Priority, Request, SamplingParams
from pddl_tpu_torch.utils.faults import (
    StorageFaultKind,
    StorageFaultPlan,
    StorageFaultSpec,
)

RECORDS = [{"cmd": "submit", "rid": 7, "prompt": [1, 2, 3],
            "max_new_tokens": 4, "sampling": {"temperature": 0.0}},
           {"ev": "tokens", "toks": [[7, [5, 6]]]},
           {"ev": "finish", "rid": 7, "state": "finished",
            "reason": "length", "ttft_s": 0.125, "n_tokens": 4},
           {"ev": "pong", "queue_depth": 0, "live_slots": 1,
            "degraded": False, "tick_wall_s": None}]


def _payloads(records):
    return [json.dumps(r, separators=(",", ":")).encode() for r in records]


def test_frames_byte_identical_and_control_lines():
    senders = (jax_transport.FrameSender(), transport.FrameSender())
    for payload in _payloads(RECORDS):
        a, b = (s.encode(payload) for s in senders)
        assert a == b
        assert transport.decode_frame(a[:-1]) == \
            jax_transport.decode_frame(b[:-1])
    assert [s.last_seq for s in senders] == [len(RECORDS)] * 2
    assert senders[0].resend_from(2) == senders[1].resend_from(2)
    ctl = {"ctl": "resend", "from": 3}
    assert transport.encode_control(ctl) == jax_transport.encode_control(ctl)
    assert transport.decode_control(jax_transport.encode_control(ctl)) == ctl
    assert transport.MAX_FRAME_BYTES == jax_transport.MAX_FRAME_BYTES
    assert transport.FRAME_MAGIC == jax_transport.FRAME_MAGIC


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_streams_decode_across_packages_with_resend_and_dups(direction):
    """A sender's stream through a lossy wire (one frame corrupted, one
    duplicated, one reordered) decodes in the other package's receiver:
    the gap asks for a resend from the first missing seq, the sender's
    buffer answers it, duplicates are suppressed, and the payloads come
    out whole and in order."""
    mods = ((jax_transport, transport) if direction == "jax_to_port"
            else (transport, jax_transport))
    sender, receiver = mods[0].FrameSender(), mods[1].FrameReceiver()
    records = RECORDS * 3
    frames = [sender.encode(p)[:-1] for p in _payloads(records)]
    corrupt = bytearray(frames[2])
    corrupt[-3] ^= 0x5A
    wire = [frames[0], frames[1], frames[1], bytes(corrupt), frames[4],
            frames[3], frames[5], frames[7], frames[6]]
    wire += frames[8:]
    got = []
    for line in wire:
        got.extend(receiver.feed(line))
    assert receiver.has_gap and receiver.expected_seq == 3
    for line in sender.resend_from(receiver.expected_seq):
        got.extend(receiver.feed(line.rstrip(b"\n")))
    assert not receiver.has_gap
    assert got == _payloads(records)
    stats = receiver.stats
    assert stats["crc_rejects"] == 1 and stats["dups"] >= 2
    assert stats["frames_ok"] == len(records)


def test_wire_fault_plans_mangle_the_same_frames():
    kw = dict(seed=3, corrupt_rate=0.2, duplicate_rate=0.1,
              reorder_rate=0.1, drop_rate=0.1)
    plans = (jax_transport.WireFaultPlan(**kw, sleep_fn=lambda _: None),
             transport.WireFaultPlan(**kw, sleep_fn=lambda _: None))
    sender = transport.FrameSender()
    for seq, payload in enumerate(_payloads(RECORDS * 5), start=1):
        line = sender.encode(payload)
        for site in ("cmd", "ev"):
            a, b = (p.apply(site, seq, line) for p in plans)
            assert a == b
    assert [p.total_injected for p in plans][0] == plans[1].total_injected


def _requests(pkg):
    """The same three requests as each package's ``Request``."""
    req, samp, pri = ((JaxRequest, JaxSampling, JaxPriority) if pkg == "jax"
                      else (Request, SamplingParams, Priority))
    return [req(prompt=[1, 2, 3, 4], max_new_tokens=5),
            req(prompt=[9, 8], max_new_tokens=3,
                sampling=samp(temperature=0.7, top_k=4), deadline_s=2.5,
                priority=pri.BATCH),
            req(prompt=[5] * 9, max_new_tokens=2, adapter="acme",
                constraint={"kind": "regex", "pattern": "[0-9]+"})]


def _drive_journal(io, directory, requests, **kw):
    """One scripted run of router events: admits, routes, token deltas,
    a finish, a fencing epoch, a checkpoint mid-run and records after
    it; a handoff too. Returns the journal (closed)."""
    j = io.RouterJournal(directory, fsync_batch_records=3, **kw)
    j.append(io.encode_fence_epoch(1), durable=True)
    for rid, req in enumerate(requests):
        j.append(io.encode_admit(rid, req, "s1" if rid == 1 else None),
                 durable=True)
        j.append(io.encode_route(rid, rid % 2, "affinity"))
    j.append(io.encode_tokens(0, [11, 12]))
    j.append(io.encode_tokens(1, [3]))
    j.append(io.encode_finish(2, "finished", "length"))
    entries = [(0, {"prompt": [1, 2, 3, 4], "max_new_tokens": 5,
                    "tokens": [11, 12], "elapsed_s": 0.5, "ttft_s": 0.25,
                    "session": None})]
    j.checkpoint(entries, next_rid=3)
    j.append(io.encode_tokens(0, [13]))
    j.append(io.encode_handoff(1, 0, 1))
    j.append(io.encode_route(1, 1, "migration"))
    j.commit()
    j.close()
    return j


def test_journal_files_byte_identical_and_read_across(tmp_path):
    """The same router events write byte-identical WAL and checkpoint
    files in both packages, the versions and manifests agree, and each
    package's ``read_state`` folds the other's directory to the same
    state as its own."""
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    _drive_journal(jax_journal, str(dirs["jax"]), _requests("jax"))
    _drive_journal(journal_io, str(dirs["port"]), _requests("port"))
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir())
    assert len(names) >= 2
    for name in names:
        assert (dirs["jax"] / name).read_bytes() == \
            (dirs["port"] / name).read_bytes(), name
    assert journal_io.JOURNAL_VERSION == jax_journal.JOURNAL_VERSION == 3
    assert journal_io._READABLE_JOURNAL_VERSIONS == \
        jax_journal._READABLE_JOURNAL_VERSIONS
    assert journal_io.RECORD_KEYS_V3 == jax_journal.RECORD_KEYS_V3
    states = {(reader, writer): io.read_state(str(dirs[writer]))
              for reader, io in (("jax", jax_journal), ("port", journal_io))
              for writer in dirs}
    first = states[("jax", "jax")]
    assert set(first[0]) == {0} and first[1] == 3  # the checkpoint rules
    assert first[0][0]["tokens"] == [11, 12, 13]
    assert all(s == first for s in states.values())


def test_storage_fault_plans_fire_alike():
    kw = dict(seed=5, eio_rate=0.2, enospc_rate=0.1, torn_rate=0.1,
              slow_rate=0.1, slow_s=0.0, sleep_fn=lambda _: None)
    jplan = JaxStoragePlan(**kw, scheduled=[
        JaxStorageSpec("fsync", 2, JaxStorageKind.EIO, count=2)])
    plan = StorageFaultPlan(**kw, scheduled=[
        StorageFaultSpec("fsync", 2, StorageFaultKind.EIO, count=2)])
    assert plan.SITES == jplan.SITES
    fired = {"jax": [], "port": []}
    for i in range(60):
        op = plan.SITES[i % len(plan.SITES)]
        for name, p in (("jax", jplan), ("port", plan)):
            try:
                kind = p.check(op)
                fired[name].append(None if kind is None else kind.value)
            except OSError as e:
                fired[name].append(e.errno)
    assert fired["jax"] == fired["port"]
    assert {k.value: v for k, v in plan.injected.items()} == \
        {k.value: v for k, v in jplan.injected.items()}
    assert plan.total_injected >= 3


def _chain_blocks(dtype):
    rng = np.random.default_rng(0)
    keys = [f"['block{i}']['attn']['cached_{kv}']"
            for i in (0, 1, 10) for kv in ("key", "value")]
    return [{k: rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
             .astype(dtype) for k in sorted(keys)} for _ in range(2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_wire_bytes_equal_and_decode_across(dtype):
    """``kv_chain_to_wire`` is byte-identical JSON in both packages for
    the same tokens and blocks (numpy arrays, or the port's CPU tensors
    of the same values), and each package decodes the other's entry to
    the same values, shapes and dtypes."""
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    blocks = _chain_blocks(np_dtype)
    tokens = list(range(8))
    want = json.dumps(jax_drain.kv_chain_to_wire(tokens, blocks))
    assert json.dumps(drain_io.kv_chain_to_wire(tokens, blocks)) == want
    tdtype = getattr(torch, dtype)
    tblocks = [{k: torch.from_numpy(v.astype(np.float32)).to(tdtype)
                for k, v in b.items()} for b in blocks]
    assert json.dumps(drain_io.kv_chain_to_wire(tokens, tblocks)) == want
    entry = json.loads(want)
    toks, got = drain_io.kv_chain_from_wire(entry)
    jtoks, jgot = jax_drain.kv_chain_from_wire(entry)
    assert toks == jtoks == tokens
    for b, jb in zip(got, jgot):
        assert list(b) == list(jb)
        for k in b:
            assert b[k].dtype == tdtype and tuple(b[k].shape) == jb[k].shape
            assert np.array_equal(b[k].float().numpy(),
                                  jb[k].astype(np.float32))
    with pytest.raises(ValueError, match="dtype"):
        bad = json.loads(want)
        bad["blocks"][0][next(iter(bad["blocks"][0]))]["dtype"] = "int64"
        drain_io.kv_chain_from_wire(bad)
