"""The port's tuning service (``repro_torch.launch.service``) and worker
daemon (``repro_torch.launch.worker``) on the CPU: the reference's cases
of ``tests/test_service.py`` — protocol-v2 negotiation, JobSpec /
TunerConfig validation over the wire, fair-share scheduling, cancel,
crash-restart recovery with zero double-recorded and zero lost results,
v1-worker compatibility and worker start-up errors — run against the
port's modules, plus ``JsonCheckpointer`` and the error texts of
``resolve_objective`` compared with the reference's exactly, a BO job
through the service, and a fleet job whose daemon never asks for a
hardware fingerprint of its own.
"""
import json
import socket
import time
from types import SimpleNamespace

import pytest
import torch

from repro.checkpoint.checkpointer import JsonCheckpointer as JJsonCheckpointer
from repro.launch.worker import resolve_objective as j_resolve_objective
from repro_torch.checkpoint.checkpointer import JsonCheckpointer
from repro_torch.core import SearchSpace, TunerConfig
from repro_torch.launch.service import ServiceClient, TuningService
from repro_torch.launch.worker import resolve_objective
from repro_torch.tuning import protocol as proto
from repro_torch.tuning.objective import CountingEvaluator
from repro_torch.tuning.protocol import (PROTOCOL_V1, PROTOCOL_V2, JobSpec, hello,
                                         negotiate, recv_msg, send_msg)
from repro_torch.tuning.remote import RemoteWorkerPool, WorkerServer

# the test processes share the host's cores: one intra-op thread each keeps
# the GP's many small operations from oversubscribing them
torch.set_num_threads(1)

SPACE = [{"type": "int", "name": "a", "min": 0, "max": 7},
         {"type": "int", "name": "b", "min": 0, "max": 3}]


def value_of(p) -> float:
    return float(p["a"] * 10 + p["b"])


def slow_value_of(p) -> float:
    time.sleep(0.02)
    return value_of(p)


def job_config(**over) -> dict:
    cfg = TunerConfig(algorithm="exhaustive", budget=8, verbose=False)
    d = cfg.to_dict()
    d.update(over)
    return d


@pytest.fixture
def service(tmp_path):
    svc = TuningService(tmp_path / "state", objective=value_of,
                        parallelism=4, verbose=False).start()
    yield svc
    svc.stop()


def wait_until(pred, timeout=20.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# ---------------------------------------------------------------------------
# protocol v2 negotiation
# ---------------------------------------------------------------------------

def test_hello_pins_protocol_floor_at_v1():
    msg = hello()
    assert msg["protocol"] == PROTOCOL_V1  # v1 servers check this exact key
    assert msg["max_protocol"] == PROTOCOL_V2


def test_negotiate_picks_min_of_ceilings():
    assert negotiate({"type": "hello", "protocol": 1}) == PROTOCOL_V1
    assert negotiate(hello()) == PROTOCOL_V2
    assert negotiate(hello(max_protocol=99)) == PROTOCOL_V2
    assert negotiate(hello(), ceiling=PROTOCOL_V1) == PROTOCOL_V1


def test_negotiate_rejects_incompatible_hellos():
    assert negotiate({"type": "hello", "protocol": 2}) is None  # floor moved
    assert negotiate({"type": "register", "protocol": 1}) is None
    assert negotiate({"type": "hello", "protocol": 1,
                      "max_protocol": "garbage"}) is None


def test_service_rejects_v1_only_clients(service):
    with socket.create_connection((service.host, service.port)) as s:
        send_msg(s, {"type": "hello", "protocol": 1})  # no max_protocol
        reply = recv_msg(s)
    assert reply["type"] == "error"
    assert "protocol" in reply["error"]


# ---------------------------------------------------------------------------
# JobSpec validation
# ---------------------------------------------------------------------------

def test_jobspec_roundtrip_and_unknown_keys():
    spec = JobSpec(space=SPACE, config=job_config(), name="n")
    assert JobSpec.from_dict(spec.to_dict()).space == SPACE
    with pytest.raises(ValueError, match="unknown"):
        JobSpec.from_dict({"space": SPACE, "budget": 5})
    with pytest.raises(ValueError):
        JobSpec.from_dict({"space": []})


# ---------------------------------------------------------------------------
# submit / status / list / cancel over the wire
# ---------------------------------------------------------------------------

def test_submit_runs_to_done_with_live_status(service):
    with ServiceClient(service.address) as client:
        job_id = client.submit(JobSpec(space=SPACE, config=job_config(),
                                       name="smoke"))
        assert job_id == "job-0001"
        st = client.wait(job_id, timeout=30)
    assert st["state"] == "done"
    assert st["n_evals"] == 8
    assert st["error"] is None
    assert st["best"]["value"] == max(
        value_of(e["point"]) for e in json.loads(
            (service.jobs_dir / job_id / "history.json").read_text()))
    # best-so-far curve is monotone and one entry per eval
    curve = st["best_curve"]
    assert len(curve) == 8 and curve == sorted(curve)


def test_list_jobs_and_errors_over_the_wire(service):
    with ServiceClient(service.address) as client:
        job_id = client.submit(JobSpec(space=SPACE, config=job_config()))
        client.wait(job_id, timeout=30)
        jobs = client.list_jobs()
        assert [j["job_id"] for j in jobs] == [job_id]
        assert jobs[0]["state"] == "done"
        with pytest.raises(RuntimeError, match="no such job"):
            client.status("job-9999")
        with pytest.raises(RuntimeError, match="no such job"):
            client.cancel("job-9999")


def test_submit_rejects_unknown_config_keys_naming_them(service):
    with ServiceClient(service.address) as client:
        with pytest.raises(RuntimeError) as e:
            client.submit(JobSpec(space=SPACE,
                                  config={"algorithm": "exhaustive",
                                          "parallelism": 2}))
    # the v1->v2 migration hint names the key's new home
    assert "parallelism" in str(e.value)
    assert "executor.parallelism" in str(e.value)


def test_submit_rejects_bad_space(service):
    with ServiceClient(service.address) as client:
        with pytest.raises(RuntimeError):
            client.submit(JobSpec(space=[{"type": "warp", "name": "x"}],
                                  config=job_config()))


def test_cancel_stops_a_running_job(tmp_path):
    svc = TuningService(tmp_path / "state", objective=slow_value_of,
                        parallelism=2, verbose=False).start()
    try:
        with ServiceClient(svc.address) as client:
            job_id = client.submit(JobSpec(
                space=SPACE, config=job_config(budget=1000)))
            assert wait_until(
                lambda: client.status(job_id).get("n_evals", 0) >= 2)
            reply = client.cancel(job_id)
            assert reply["was_running"] is True
            st = client.wait(job_id, timeout=30)
        assert st["state"] == "cancelled"
        assert 0 < st["n_evals"] < 1000
    finally:
        svc.stop()


def test_two_concurrent_jobs_share_the_fleet_and_finish(tmp_path):
    svc = TuningService(tmp_path / "state", objective=slow_value_of,
                        parallelism=4, verbose=False).start()
    try:
        with ServiceClient(svc.address) as client:
            ids = [client.submit(JobSpec(space=SPACE,
                                         config=job_config(budget=12),
                                         name=f"j{i}"))
                   for i in range(2)]
            sts = [client.wait(j, timeout=60) for j in ids]
        for st in sts:
            assert st["state"] == "done"
            assert st["n_evals"] == 12
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# fair-share slot governor
# ---------------------------------------------------------------------------

def _stub_job(job_id):
    return SimpleNamespace(job_id=job_id, state="running",
                           tuner=SimpleNamespace(
                               executor=SimpleNamespace(slot_cap=None),
                               request_stop=lambda: None),
                           thread=None)


def test_rebalance_splits_slots_with_min_one(tmp_path):
    svc = TuningService(tmp_path / "state", objective=value_of,
                        parallelism=5, verbose=False)
    try:
        jobs = [_stub_job(f"job-{i:04d}") for i in range(1, 4)]
        svc._jobs = {j.job_id: j for j in jobs}
        svc._rebalance()
        caps = [j.tuner.executor.slot_cap for j in jobs]
        assert sum(caps) == 5
        assert max(caps) - min(caps) <= 1  # 5 slots / 3 jobs -> 2,2,1
        # oversubscribed: every runnable job still gets one slot
        svc._jobs = {j.job_id: j
                     for j in [_stub_job(f"job-{i:04d}") for i in range(1, 9)]}
        svc._rebalance()
        assert all(j.tuner.executor.slot_cap == 1
                   for j in svc._jobs.values())
    finally:
        svc.stop()


def test_rebalance_rotates_the_remainder(tmp_path):
    svc = TuningService(tmp_path / "state", objective=value_of,
                        parallelism=5, verbose=False)
    try:
        jobs = [_stub_job(f"job-{i:04d}") for i in range(1, 3)]
        svc._jobs = {j.job_id: j for j in jobs}
        svc._rebalance()
        first = [j.tuner.executor.slot_cap for j in jobs]
        svc._rebalance(rotate=True)
        second = [j.tuner.executor.slot_cap for j in jobs]
        assert sorted(first) == sorted(second) == [2, 3]
        assert first != second  # the bonus slot moved to the other job
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# crash-restart recovery
# ---------------------------------------------------------------------------

def test_restart_resumes_unfinished_jobs_exactly_once(tmp_path):
    """Daemon dies mid-run; a new daemon on the same state dir resumes
    the job, loses only in-flight work, re-measures nothing that was
    checkpointed, and double-records nothing."""
    state = tmp_path / "state"
    budget = 30
    svc1 = TuningService(state, objective=slow_value_of, parallelism=2,
                         verbose=False).start()
    with ServiceClient(svc1.address) as client:
        job_id = client.submit(JobSpec(space=SPACE,
                                       config=job_config(budget=budget)))
        assert wait_until(
            lambda: client.status(job_id).get("n_evals", 0) >= 4)
    svc1.stop()  # jobs stop at next completion; doc stays non-terminal

    hist_path = state / "jobs" / job_id / "history.json"
    before = json.loads(hist_path.read_text())
    assert 0 < len(before) < budget  # genuinely mid-run

    counting = CountingEvaluator(value_of)
    svc2 = TuningService(state, objective=counting, parallelism=2,
                         verbose=False).start()
    try:
        with ServiceClient(svc2.address) as client:
            st = client.wait(job_id, timeout=60)
        assert st["state"] == "done"
        assert st["n_evals"] == budget
        after = json.loads(hist_path.read_text())
        # zero lost completed results: the checkpointed prefix survived
        assert after[:len(before)] == before
        # zero double-recorded: every point appears exactly once
        keys = [tuple(sorted(e["point"].items())) for e in after]
        assert len(keys) == len(set(keys))
        # nothing checkpointed was measured again
        assert counting.calls == budget - len(before)
    finally:
        svc2.stop()


def test_restart_registers_finished_jobs_without_relaunch(tmp_path):
    state = tmp_path / "state"
    svc1 = TuningService(state, objective=value_of, parallelism=2,
                         verbose=False).start()
    with ServiceClient(svc1.address) as client:
        job_id = client.submit(JobSpec(space=SPACE, config=job_config()))
        client.wait(job_id, timeout=30)
    svc1.stop()

    svc2 = TuningService(state, objective=value_of, parallelism=2,
                         verbose=False).start()
    try:
        with ServiceClient(svc2.address) as client:
            st = client.status(job_id)
            assert st["state"] == "done"
            assert st["n_evals"] == 8  # recomputed from history on disk
            # fresh submissions do not collide with recovered ids
            new_id = client.submit(JobSpec(space=SPACE, config=job_config()))
            assert new_id != job_id
            client.wait(new_id, timeout=30)
    finally:
        svc2.stop()


# ---------------------------------------------------------------------------
# per-job objectives (local mode)
# ---------------------------------------------------------------------------

def test_daemon_without_objective_requires_job_spec(tmp_path, monkeypatch):
    (tmp_path / "objmod.py").write_text(
        "def make():\n"
        "    return lambda p: float(p['a'] + p['b'])\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    svc = TuningService(tmp_path / "state", parallelism=2,
                        verbose=False).start()
    try:
        with ServiceClient(svc.address) as client:
            with pytest.raises(RuntimeError, match="objective"):
                client.submit(JobSpec(space=SPACE, config=job_config()))
            with pytest.raises(RuntimeError, match="no attribute"):
                client.submit(JobSpec(space=SPACE, config=job_config(),
                                      objective="objmod:nope()"))
            job_id = client.submit(JobSpec(space=SPACE, config=job_config(),
                                           objective="objmod:make()"))
            st = client.wait(job_id, timeout=30)
        assert st["state"] == "done"
        # the job ran the per-job objective (a + b), not the default
        hist = json.loads((svc.jobs_dir / job_id / "history.json")
                          .read_text())
        assert st["best"]["value"] == max(
            e["point"]["a"] + e["point"]["b"] for e in hist)
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# v1 worker compatibility + worker startup-error mode
# ---------------------------------------------------------------------------

def test_v1_worker_still_registers_with_v2_pool():
    server = WorkerServer(value_of, slots=2,
                          protocol_ceiling=PROTOCOL_V1).start()
    try:
        pool = RemoteWorkerPool([f"{server.host}:{server.port}"])
        try:
            health = pool.fleet_health()
            assert health[0]["protocol"] == PROTOCOL_V1
            assert health[0]["slots"] == 2
        finally:
            pool.shutdown()
    finally:
        server.stop()


def test_v2_worker_negotiates_v2():
    server = WorkerServer(value_of, slots=1).start()
    try:
        pool = RemoteWorkerPool([f"{server.host}:{server.port}"])
        try:
            assert pool.fleet_health()[0]["protocol"] == PROTOCOL_V2
        finally:
            pool.shutdown()
    finally:
        server.stop()


def test_worker_startup_error_reaches_the_tuner():
    server = WorkerServer(None, startup_error="objective spec 'x:y' "
                          "failed: No module named 'x'").start()
    try:
        with pytest.raises(ConnectionError) as e:
            RemoteWorkerPool([f"{server.host}:{server.port}"])
        assert "failed at startup" in str(e.value)
        assert "No module named 'x'" in str(e.value)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# --objective spec resolution error messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,match", [
    ("no_colon_here", "not module:attr"),
    ("definitely_not_a_module:thing", "cannot import module"),
    ("math:not_a_real_attr", "no attribute"),
    ("math:sqrt(4)", "not a plain attribute"),  # args are not supported
    ("math:sqrt()", "raised"),  # factory raises (missing arg)
])
def test_resolve_objective_error_messages(spec, match):
    with pytest.raises(ValueError, match=match) as mine:
        resolve_objective(spec)
    with pytest.raises(ValueError) as ref:
        j_resolve_objective(spec)
    assert str(mine.value) == str(ref.value)


def test_resolve_objective_builds_a_factory_on_the_worker():
    obj = resolve_objective(
        "repro_torch.benchmarks.perf_iterations:make_remote_bench_objective()")
    value, meta = obj({"inter_op": 11, "intra_op": 60, "build": 3})
    assert value == pytest.approx(84.1, abs=0.1) and meta["cost_seconds"] > 0


# ---------------------------------------------------------------------------
# TunerConfig v2 schema
# ---------------------------------------------------------------------------

def test_tunerconfig_v2_roundtrip_and_legacy_delegates():
    cfg = TunerConfig(algorithm="ga", budget=7, parallelism=3, mf_eta=2.0)
    assert cfg.executor.parallelism == 3  # flat spelling -> nested home
    assert cfg.multi_fidelity.eta == 2.0
    cfg.parallelism = 5
    assert cfg.executor.parallelism == 5

    again = TunerConfig.from_dict(cfg.to_dict())
    assert again.to_dict() == cfg.to_dict()

    with pytest.raises(ValueError) as e:
        TunerConfig.from_dict({"budget": 5, "parallelism": 2})
    assert "executor.parallelism" in str(e.value)
    with pytest.raises(ValueError, match="unknown"):
        TunerConfig.from_dict({"executor": {"warp_factor": 9}})


def test_multi_fidelity_config_bool_semantics():
    assert not TunerConfig(multi_fidelity=False).multi_fidelity
    assert TunerConfig(multi_fidelity=True).multi_fidelity
    cfg = TunerConfig.from_dict(
        {"multi_fidelity": {"enabled": False, "eta": 2.0}})
    assert not cfg.multi_fidelity  # truthiness means "is it on"
    assert cfg.multi_fidelity.eta == 2.0  # knobs survive while disabled


def test_space_to_dicts_roundtrip():
    space = SearchSpace.from_dicts(SPACE + [
        {"type": "cat", "name": "c", "choices": [1, "x"]}])
    assert SearchSpace.from_dicts(space.to_dicts()).to_dicts() \
        == space.to_dicts()
    assert space.to_dicts()[0] == {"type": "int", "name": "a",
                                   "min": 0, "max": 7, "step": 1}


@pytest.mark.parametrize("module", ["repro_torch.tuning.protocol",
                                    "repro_torch.launch.service",
                                    "repro_torch.checkpoint.checkpointer"])
def test_thin_client_modules_are_stdlib_only(module):
    """Thin clients import the protocol and the service client, and the
    daemons checkpoint, on hosts with no accelerator stack: none of these
    modules pulls torch or numpy in."""
    import pathlib
    import subprocess
    import sys

    src = str(pathlib.Path(proto.__file__).resolve().parents[2])
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; import {module}; "
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'numpy', 'torch', 'repro')]; print(bad)"],
        capture_output=True, text=True, env={"PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# JsonCheckpointer (stdlib; compared with the reference's)
# ---------------------------------------------------------------------------

def test_json_checkpointer_matches_reference(tmp_path):
    docs = [{"job_id": "job-0001", "state": s, "n": i, "x": float("inf")}
            for i, s in enumerate(("pending", "running", "running", "done"))]
    mine, ref = JsonCheckpointer(tmp_path / "a", keep_last=2), \
        JJsonCheckpointer(tmp_path / "b", keep_last=2)
    assert [mine.save(d) for d in docs] == [ref.save(d) for d in docs] == [0, 1, 2, 3]
    assert mine.load() == ref.load() == docs[-1]
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "b").iterdir()) \
        == ["snap_00000002.json", "snap_00000003.json"]
    for name in names:  # same payload and digest, byte for byte
        a = json.loads((tmp_path / "a" / name).read_text())
        b = json.loads((tmp_path / "b" / name).read_text())
        assert (a["doc"], a["sha256"]) == (b["doc"], b["sha256"])


def test_json_checkpointer_skips_a_torn_snapshot(tmp_path):
    ck = JsonCheckpointer(tmp_path, keep_last=3)
    ck.save({"v": 1})
    ck.save({"v": 2})
    newest = tmp_path / "snap_00000001.json"
    newest.write_text(newest.read_text()[:-7])  # truncated by a crash
    assert ck.load() == {"v": 1}
    wrapper = json.loads((tmp_path / "snap_00000000.json").read_text())
    wrapper["doc"] = wrapper["doc"].replace("1", "9")  # payload no longer matches
    (tmp_path / "snap_00000000.json").write_text(json.dumps(wrapper))
    assert ck.load() is None
    (tmp_path / "snap_junk.json").write_text("{}")
    assert ck.save({"v": 3}) == 2 and ck.load() == {"v": 3}


# ---------------------------------------------------------------------------
# BO jobs; a fleet daemon describes its records by the workers' hardware
# ---------------------------------------------------------------------------

def test_bo_job_runs_through_the_service(tmp_path):
    svc = TuningService(tmp_path / "state", objective=value_of, parallelism=1,
                        verbose=False).start()
    try:
        with ServiceClient(svc.address) as client:
            cfg = TunerConfig(algorithm="bo", budget=8, seed=0, verbose=False).to_dict()
            job_id = client.submit(JobSpec(space=SPACE, config=cfg, name="bo"))
            st = client.wait(job_id, timeout=60)
        assert st["state"] == "done" and st["n_evals"] == 8
        assert st["best"]["value"] == max(
            value_of(e["point"]) for e in json.loads(
                (svc.jobs_dir / job_id / "history.json").read_text()))
        corpus = json.loads((tmp_path / "state" / "corpus.json").read_text())
        assert len(corpus) == 8  # every job records into the daemon's corpus
    finally:
        svc.stop()


def test_fleet_daemon_never_fingerprints_its_own_host(tmp_path, monkeypatch):
    """Over a worker fleet the daemon's corpus records carry the fingerprint
    the worker registered with; the daemon never calls
    ``hardware_fingerprint`` itself (on a GPU host that would initialise
    CUDA in the daemon)."""
    from repro_torch.tuning import tundb

    card = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1}
    server = WorkerServer(value_of, slots=2, fingerprint=card).start()

    asked = []
    monkeypatch.setattr(tundb, "hardware_fingerprint", lambda *a, **k: asked.append(a))
    svc = TuningService(tmp_path / "state", workers=[f"{server.host}:{server.port}"],
                        verbose=False).start()
    try:
        with ServiceClient(svc.address) as client:
            cfg = TunerConfig(algorithm="bo", budget=6, seed=1, verbose=False).to_dict()
            st = client.wait(client.submit(JobSpec(space=SPACE, config=cfg)), timeout=60)
        assert st["state"] == "done" and st["n_evals"] == 6, st
        recs = json.loads((tmp_path / "state" / "corpus.json").read_text()).values()
        assert len(recs) == 6
        assert all(r["workload"]["hardware"] == card for r in recs)
        assert asked == []
    finally:
        svc.stop()
        server.stop()
