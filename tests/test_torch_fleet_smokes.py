"""``repro_torch.benchmarks.elastic_smoke`` and ``scheduler_smoke``
against real ``python -m repro_torch.launch.worker`` subprocesses: their
accounting gates.  SIGKILLing a straggler host with a live speculative
duplicate loses nothing; a fleet never mixes two hardware fingerprints; a
PBT run survives a worker kill with no duplicate and no lost (lineage,
step).  The wall-clock gates (a join raises throughput, speculation cuts
the wall clock, HyperBand within ASHA's) are ``--check``'s only: under a
loaded test run they read the host's load, not the code."""
import pathlib

from repro_torch.benchmarks import elastic_smoke, scheduler_smoke

ROOT = pathlib.Path(elastic_smoke.__file__).resolve().parents[3]
QUIET = lambda *_: None


def test_the_smokes_serve_their_objectives_from_the_port():
    assert (ROOT / "src" / "repro_torch").is_dir()
    value, meta = elastic_smoke.make_smoke_objective()({"a": 3, "b": 4})
    assert value == 34.0 and meta == {"cost_seconds": elastic_smoke.BASE_SLEEP_S}


def test_a_killed_straggler_loses_nothing():
    res = elastic_smoke.bench_sigkill_exactly_once(ROOT, QUIET)
    assert res["lost"] == 0 and res["results"] == res["expected"] and res["values_ok"]


def test_a_fleet_never_mixes_fingerprints():
    res = elastic_smoke.bench_strict_homogeneity(ROOT, QUIET)
    assert res["static_refused"] and res["join_rejected"] and res["run_survived"]


def test_pbt_survives_a_worker_kill_exactly_once():
    res = scheduler_smoke.bench_fork_kill(ROOT, QUIET)
    assert res["finished"] and res["duplicates"] == 0 and res["lost"] == 0
    assert res["forks"] >= 1 and res["warm_resumed"] >= 1
