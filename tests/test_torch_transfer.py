"""The port's transfer learning (``repro_torch.tuning.corpus``, the
``TransferPrior`` warm start, the tuner's corpus pre-filter) on the CPU:
the reference's cases of ``tests/test_transfer.py`` run against the
port's modules, and where the code under test is numpy or stdlib the
port's answer is compared with the reference's exactly.

A configured but unhelpful corpus (empty, or beyond ``max_distance``)
must leave the tuning trace byte-identical: the port reproduces the
golden ``bo:0`` trace with and without one.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.tuning import corpus as jcorpus
from repro.core import SearchSpace as JSearchSpace
from repro_torch.core import (History, Observation, SearchSpace, TransferConfig,
                              Tuner, TunerConfig)
from repro_torch.core.bayesopt import BayesOpt, TransferPrior
from repro_torch.tuning.corpus import (TuningCorpus, hardware_descriptor,
                                       prediction_agreement, space_fingerprint,
                                       task_features, workload_distance)
from repro_torch.tuning.executor import (EvalResult, EvaluationExecutor, MemoCache,
                                         _store_key, memo_key)
from repro_torch.tuning.objective import Evaluator
from repro_torch.tuning.tundb import hardware_fingerprint

# the test processes share the host's cores: one intra-op thread each keeps
# the GP's many small operations from oversubscribing them
torch.set_num_threads(1)

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "ask_tell_traces.json")
    .read_text())


def golden_space() -> SearchSpace:
    return SearchSpace.from_dicts(GOLDEN["space"])


def golden_objective(p):
    a, b, c = p["inter_op"], p["intra_op"], p["build"]
    return float(50.0 * pow(2.718281828, -((a - 11) / 5.0) ** 2)
                 + 0.3 * b - 0.004 * (b - 25) ** 2 + 7.0 * c)


class FeaturedObjective(Evaluator):
    """Synthetic workload with declared task features."""

    def __init__(self, features, value_fn=golden_objective):
        self.features = dict(features)
        self.value_fn = value_fn
        self.calls = 0

    def task_features(self):
        return dict(self.features)

    def __call__(self, p, fidelity=None):
        self.calls += 1
        return self.value_fn(p), {"cost_seconds": 0.01}


def _populate(corpus_path, job_id, features, points_values,
              space=None, objective=None):
    space = space or golden_space()
    corpus = TuningCorpus(corpus_path, job_id=job_id)
    corpus.describe_job(objective or FeaturedObjective(features), space)
    for p, v in points_values:
        corpus.add(p, v, cost_seconds=0.02)
    corpus.flush()
    return corpus


# ---------------------------------------------------------------------------
# similarity layer
# ---------------------------------------------------------------------------

def test_workload_distance_properties():
    a = {"flops": 1e12, "bytes": 4e9}
    assert workload_distance(a, a) == 0.0
    assert workload_distance({}, {}) == 0.0  # same space, nothing known
    near = {"flops": 1.1e12, "bytes": 4.4e9}
    far = {"flops": 1e14, "bytes": 4e11}
    assert workload_distance(a, near) < workload_distance(a, far)
    # a feature only one side declares counts as maximally different
    assert workload_distance(a, {"flops": 1e12}) == pytest.approx(0.5)
    # symmetric
    assert workload_distance(a, far) == pytest.approx(
        workload_distance(far, a))
    for x, y in ((a, a), ({}, {}), (a, near), (a, far), (a, {"flops": 1e12}), (far, a)):
        assert workload_distance(x, y) == jcorpus.workload_distance(x, y)


def test_task_features_coercion_and_fallbacks():
    assert task_features(lambda p: 1.0) == {}  # plain callables: no hook
    obj = FeaturedObjective({"flops": 5, "bad": "nan-ish",
                             "inf": float("inf")})
    obj.features["bad"] = float("nan")
    feats = task_features(obj)
    assert feats == {"flops": 5.0}  # non-finite / non-numeric dropped

    class Exploding:
        def task_features(self):
            raise RuntimeError("harness not built yet")

    assert task_features(Exploding()) == {}
    assert feats == jcorpus.task_features(obj)


def test_prediction_agreement_degenerate_cases():
    assert prediction_agreement([1.0], [2.0]) is None  # < 2 pairs
    assert prediction_agreement([1, 2], [5, 5]) is None  # constant side
    assert prediction_agreement([1, 2, 3], [1, 2]) is None  # mismatch
    assert prediction_agreement([1, 2, 3], [2, 4, 6]) == pytest.approx(1.0)
    assert prediction_agreement([1, 2, 3], [3, 2, 1]) == pytest.approx(-1.0)
    for p, a in (([1.0], [2.0]), ([1, 2], [5, 5]), ([1, 2, 3], [2, 4, 7]),
                 ([0.5, 0.1, 0.9, 0.3], [3, 1, 2, 0])):
        assert prediction_agreement(p, a) == jcorpus.prediction_agreement(p, a)


def test_space_fingerprint_matches_reference():
    assert space_fingerprint(golden_space()) == jcorpus.space_fingerprint(
        JSearchSpace.from_dicts(GOLDEN["space"]))


def test_corpus_reads_match_reference(tmp_path):
    """Populated alike, the two packages' corpora return the same neighbour
    groups and the same prior rows (each on its own file, read on its own
    hardware descriptor)."""
    feats = {"flops": 1e12, "bytes": 4e9}
    pts = golden_space().sample(np.random.default_rng(4), 30)
    jobs = [("near", {"flops": 1.1e12, "bytes": 4e9}), ("same", feats),
            ("far", {"flops": 1e15, "bytes": 4e12})]
    reads = []
    for mod, Space in ((jcorpus, JSearchSpace), (None, SearchSpace)):
        Corpus = TuningCorpus if mod is None else mod.TuningCorpus
        space = Space.from_dicts(GOLDEN["space"])
        path = tmp_path / ("ref.json" if mod else "port.json")
        for i, (job, f) in enumerate(jobs):
            c = Corpus(path, job_id=job)
            c.describe_job(FeaturedObjective(f), space)
            for j, p in enumerate(pts):
                c.add(p, float(golden_objective(p) + i) if j % 7 else float("-inf"), 0.02)
            c.flush()
        reader = Corpus(path, job_id="me")
        near = [(g["job_id"], g["distance"], len(g["records"]))
                for g in reader.neighbors(space, feats)]
        rows = reader.prior_observations(space, feats, max_rows=12)
        reads.append((near, rows))
    assert reads[0] == reads[1]
    assert len(reads[1][1]) == 12


def test_corpus_records_the_port_fingerprint_and_tells_reference_records_apart(tmp_path):
    """Records carry the port's hardware fingerprint; a record written by
    the reference package (another descriptor) is another machine to the
    port: it is read with the hardware penalty, never as evidence of the
    same hardware.  A pinned ``hardware`` (a fleet's) replaces this
    process's descriptor on both the write and the read side."""
    path = tmp_path / "corpus.json"
    space, jspace = golden_space(), JSearchSpace.from_dicts(GOLDEN["space"])
    feats = {"flops": 1e12}
    p = {"inter_op": 3, "intra_op": 10, "build": 1}
    _populate(path, "port-job", feats, [(p, 1.0)])
    ref = jcorpus.TuningCorpus(path, job_id="ref-job")
    ref.describe_job(FeaturedObjective(feats), jspace)
    ref.add(p, 2.0)
    ref.flush()
    assert hardware_descriptor() == hardware_fingerprint()
    by_job = {r["workload"]["job_id"]: r["workload"]["hardware"]
              for r in TuningCorpus(path, job_id="x").records()}
    assert by_job["port-job"] == hardware_fingerprint() != by_job["ref-job"]
    near = {g["job_id"]: g["distance"]
            for g in TuningCorpus(path, job_id="me").neighbors(space, feats)}
    assert near == {"port-job": 0.0, "ref-job": pytest.approx(0.2)}

    fleet = {"backend": "cuda", "device_kind": "a card elsewhere"}
    pinned = TuningCorpus(path, job_id="fleet-job", hardware=fleet)
    pinned.describe_job(FeaturedObjective(feats), space)
    pinned.add(p, 3.0)
    pinned.flush()
    assert pinned.descriptor["hardware"] == fleet
    near = {g["job_id"]: g["distance"] for g in pinned.neighbors(space, feats)}
    assert near == {"port-job": pytest.approx(0.2), "ref-job": pytest.approx(0.2)}


# ---------------------------------------------------------------------------
# corpus storage + neighbor selection
# ---------------------------------------------------------------------------

def test_corpus_roundtrip_persists_across_instances(tmp_path):
    path = tmp_path / "corpus.json"
    space = golden_space()
    feats = {"flops": 1e12}
    pts = space.sample(np.random.default_rng(0), 4)
    _populate(path, "writer", feats, [(p, golden_objective(p)) for p in pts])

    reader = TuningCorpus(path, job_id="reader")
    recs = reader.records()
    assert len(recs) == 4
    for rec in recs:
        assert rec["workload"]["job_id"] == "writer"
        assert rec["workload"]["space"] == space_fingerprint(space)
        assert rec["cost_seconds"] == pytest.approx(0.02)
    rows = reader.prior_observations(space, feats)
    assert len(rows) == 4
    assert all(r["distance"] == 0.0 for r in rows)


def test_corpus_rerun_with_same_job_id_appends_not_overwrites(tmp_path):
    """Crash-resume reuses job.job_id and launch/tune.py derives
    deterministic job_ids, so two *processes* writing under the same
    job_id must union their records — the per-process key nonce keeps a
    re-run from overwriting the earlier run at the same key indices."""
    path = tmp_path / "corpus.json"
    space = golden_space()
    feats = {"flops": 1e12}
    p = {"inter_op": 3, "intra_op": 10, "build": 1}
    # two corpus instances = two processes resuming the same job
    _populate(path, "job-A", feats, [(p, 1.0), (p, 2.0)])
    _populate(path, "job-A", feats, [(p, 3.0), (p, 4.0)])
    recs = TuningCorpus(path, job_id="reader").records()
    assert sorted(r["value"] for r in recs) == [1.0, 2.0, 3.0, 4.0]


def test_corpus_add_requires_descriptor(tmp_path):
    corpus = TuningCorpus(tmp_path / "c.json", job_id="j")
    with pytest.raises(RuntimeError, match="describe_job"):
        corpus.add({"inter_op": 1, "intra_op": 0, "build": 1}, 1.0)


def test_neighbors_filter_space_distance_and_own_job(tmp_path):
    path = tmp_path / "corpus.json"
    space = golden_space()
    p = {"inter_op": 3, "intra_op": 10, "build": 1}
    base = {"flops": 1e12, "bytes": 4e9}
    _populate(path, "near", base, [(p, 1.0)])
    _populate(path, "far", {"flops": 1e15, "bytes": 4e12}, [(p, 2.0)])
    other_space = SearchSpace.from_dicts(
        [{"type": "int", "name": "inter_op", "min": 1, "max": 4}])
    _populate(path, "other-space", base,
              [({"inter_op": 2}, 3.0)], space=other_space)

    reader = TuningCorpus(path, job_id="me")
    near = reader.neighbors(space, base)
    assert [g["job_id"] for g in near] == ["near"]  # far + other-space cut
    assert near[0]["distance"] == 0.0
    # a job never sees itself as a neighbor (no self-transfer)
    assert reader.neighbors(space, base, exclude_job="near") == []


def test_prior_observations_skip_failures_and_stale_points(tmp_path):
    path = tmp_path / "corpus.json"
    space = golden_space()
    feats = {"flops": 1e12}
    good = {"inter_op": 3, "intra_op": 10, "build": 1}
    stale = {"inter_op": 99, "intra_op": 10, "build": 1}  # not on the grid
    _populate(path, "donor", feats,
              [(good, 5.0), (good, float("-inf")), (stale, 9.0)])
    rows = TuningCorpus(path, job_id="me").prior_observations(space, feats)
    assert [r["value"] for r in rows] == [5.0]


def test_prior_observations_quota_keeps_value_spread(tmp_path):
    path = tmp_path / "corpus.json"
    space = golden_space()
    feats = {"flops": 1e12}
    pts = space.sample(np.random.default_rng(1), 30)
    _populate(path, "donor", feats,
              [(p, float(i)) for i, p in enumerate(pts)])
    rows = TuningCorpus(path, job_id="me").prior_observations(
        space, feats, max_rows=8)
    values = sorted(r["value"] for r in rows)
    assert len(rows) <= 8
    assert values[0] == 0.0 and values[-1] == 29.0  # floor and peak kept


# ---------------------------------------------------------------------------
# TransferPrior + engine warm-start
# ---------------------------------------------------------------------------

def _prior_from(space, points_values, distance=0.1):
    rows = [{"point": p, "value": v, "distance": distance}
            for p, v in points_values]
    return TransferPrior.from_rows(space, rows)


def test_transfer_prior_predict_and_noise_scale():
    space = golden_space()
    pts = space.sample(np.random.default_rng(2), 12)
    prior = _prior_from(space, [(p, golden_objective(p)) for p in pts])
    pred = prior.predict(space.encode_many(pts))
    from repro.core.bayesopt import TransferPrior as JTransferPrior
    jprior = JTransferPrior.from_rows(JSearchSpace.from_dicts(GOLDEN["space"]),
                                      [{"point": p, "value": golden_objective(p),
                                        "distance": 0.1} for p in pts])
    np.testing.assert_array_equal(pred, jprior.predict(space.encode_many(pts)))
    # NW at the observed points themselves must correlate strongly
    assert np.corrcoef(pred, prior.y)[0, 1] > 0.8
    assert prior.best_point() in [dict(p) for p in pts]
    # noise inflation: >= 1 everywhere, grows with real-observation count
    n0, n8 = prior.noise_scale(0, 24), prior.noise_scale(8, 24)
    assert (n0 >= 1.0).all() and (n8 > n0).all()
    # and with workload distance
    far = _prior_from(space, [(p, golden_objective(p)) for p in pts],
                      distance=0.9)
    assert (far.noise_scale(0, 24) > prior.noise_scale(0, 24)).all()


def test_warm_started_engine_first_ask_exploits_prior():
    """With a trustworthy neighbor prior, the first ask skips the LHS
    design phase and lands near the prior's optimum region."""
    space = golden_space()
    pts = space.sample(np.random.default_rng(3), 24)
    prior = _prior_from(space, [(p, golden_objective(p)) for p in pts])
    eng = BayesOpt(space, seed=0, transfer_prior=prior)
    h = History(space)
    batch = eng.ask(1, h)
    assert len(batch) == 1
    # cold engine at the same seed is still in its LHS phase
    cold = BayesOpt(space, seed=0).ask(1, History(space))
    assert eng._init_points is None  # no LHS design was drawn
    best_prior_v = max(golden_objective(p) for p in pts)
    assert golden_objective(batch[0]) >= best_prior_v - 10.0
    assert cold != batch or True  # traces may coincide; the real pin is above


def test_prior_retires_after_decay_evals():
    space = golden_space()
    pts = space.sample(np.random.default_rng(4), 8)
    prior = _prior_from(space, [(p, golden_objective(p)) for p in pts])
    eng = BayesOpt(space, seed=0, transfer_prior=prior, transfer_decay=4)
    h = History(space)
    for p in space.sample(np.random.default_rng(5), 4):
        v = golden_objective(p)
        eng.tell([Observation(point=p, value=v)])
        h.add(p, v)
    assert eng._active_prior(h) is None  # decayed out, permanently
    assert eng._prior_dropped


def test_negative_transfer_guard_drops_anticorrelated_prior():
    space = golden_space()
    pts = space.sample(np.random.default_rng(6), 16)
    # the prior claims the landscape is inverted
    prior = _prior_from(space, [(p, -golden_objective(p)) for p in pts])
    eng = BayesOpt(space, seed=0, transfer_prior=prior, transfer_guard_n=3)
    h = History(space)
    for p in space.sample(np.random.default_rng(7), 3):
        v = golden_objective(p)
        eng.tell([Observation(point=p, value=v)])
        h.add(p, v)
    assert eng._active_prior(h) is None
    assert eng._prior_dropped
    # an agreeing prior survives the same check
    good = _prior_from(space, [(p, golden_objective(p)) for p in pts])
    eng2 = BayesOpt(space, seed=0, transfer_prior=good, transfer_guard_n=3)
    h2 = History(space)
    for p in space.sample(np.random.default_rng(7), 3):
        v = golden_objective(p)
        eng2.tell([Observation(point=p, value=v)])
        h2.add(p, v)
    assert eng2._active_prior(h2) is good
    assert not eng2._prior_dropped


# ---------------------------------------------------------------------------
# tuner integration: warm-start, pre-filter, unchanged-trace invariants
# ---------------------------------------------------------------------------

def test_tuner_records_into_corpus_and_warm_run_reuses_it(tmp_path):
    corpus_path = tmp_path / "corpus.json"
    space = golden_space()
    feats = {"flops": 1e12, "bytes": 4e9}

    donor = FeaturedObjective(feats)
    t = Tuner(donor, space,
              TunerConfig(algorithm="random", budget=10, seed=0,
                          verbose=False,
                          transfer=TransferConfig(
                              corpus_path=str(corpus_path),
                              job_id="donor")))
    t.run()
    t.close()
    assert len(json.loads(corpus_path.read_text())) == 10

    # a BO job on a near workload builds a prior from the donor records
    warm_obj = FeaturedObjective({"flops": 1.1e12, "bytes": 4.4e9})
    warm = Tuner(warm_obj, space,
                 TunerConfig(algorithm="bo", budget=2, seed=0,
                             verbose=False,
                             transfer=TransferConfig(
                                 corpus_path=str(corpus_path),
                                 job_id="warm")))
    assert warm._transfer_prior is not None
    assert len(warm._transfer_prior) == 10
    assert warm.engine.transfer_prior is warm._transfer_prior
    assert warm._prefilter_on
    warm.close()

    # warm_start off -> the engine never sees the prior; the tuner-level
    # pre-filter is the only consumer and stays on
    filt = Tuner(FeaturedObjective({"flops": 1.1e12, "bytes": 4.4e9}), space,
                 TunerConfig(algorithm="bo", budget=2, seed=0,
                             verbose=False,
                             transfer=TransferConfig(
                                 corpus_path=str(corpus_path),
                                 job_id="filt", warm_start=False)))
    assert filt._transfer_prior is not None
    assert getattr(filt.engine, "transfer_prior", None) is None
    assert filt._prefilter_on
    filt.close()


def test_empty_or_dissimilar_corpus_leaves_trace_byte_identical(tmp_path):
    """A configured corpus with nothing relevant in it must not perturb
    the tuning trace at all — the golden parallelism=1 trace is
    reproduced byte-for-byte through the full transfer-enabled path."""
    empty = tmp_path / "empty.json"
    trace = GOLDEN["traces"]["bo:0"]
    t = Tuner(golden_objective, golden_space(),
              TunerConfig(algorithm="bo", budget=18, seed=0, verbose=False,
                          parallelism=1,
                          transfer=TransferConfig(corpus_path=str(empty),
                                                  job_id="fresh")))
    h = t.run()
    t.close()
    assert h.points() == trace["points"]
    assert [e.value for e in h.evals] == pytest.approx(trace["values"])


def test_prefilter_respects_unsafe_engines(tmp_path):
    """Nelder-Mead's speculative batches must never be pre-filtered."""
    corpus_path = tmp_path / "corpus.json"
    space = golden_space()
    feats = {"flops": 1e12}
    pts = space.sample(np.random.default_rng(8), 12)
    _populate(corpus_path, "donor", feats,
              [(p, golden_objective(p)) for p in pts])
    t = Tuner(FeaturedObjective(feats), space,
              TunerConfig(algorithm="nms", budget=4, seed=0, verbose=False,
                          transfer=TransferConfig(
                              corpus_path=str(corpus_path), job_id="nms")))
    assert t._transfer_prior is not None  # the prior exists...
    assert not t._prefilter_on            # ...but NMS opts out
    t.run()
    t.close()


def test_prefilter_never_promotes_random_fills_over_ranked_head(tmp_path):
    """An engine that pads an exhausted candidate pool with random fills
    reports the ranked head (``last_ask_ranked``); the filter must only
    re-rank the head — a fill scored by the same prior must never
    displace a candidate the engine actually ranked."""
    corpus_path = tmp_path / "corpus.json"
    space = golden_space()
    feats = {"flops": 1e12}
    pts = space.sample(np.random.default_rng(9), 8)
    _populate(corpus_path, "donor", feats,
              [(p, golden_objective(p)) for p in pts])
    t = Tuner(FeaturedObjective(feats), space,
              TunerConfig(algorithm="random", budget=4, seed=0, verbose=False,
                          transfer=TransferConfig(
                              corpus_path=str(corpus_path), job_id="me",
                              keep_fraction=0.4)))
    assert t._prefilter_on
    cands = space.sample(np.random.default_rng(10), 5)

    class FakePrior:  # scores strictly increasing by candidate index
        def predict(self, X):
            return np.arange(np.asarray(X).shape[0], dtype=float)

    t._transfer_prior = FakePrior()
    t.engine.ask = lambda n, h: [dict(c) for c in cands[:n]]
    # no ranked/fill boundary declared: the whole batch competes
    t.engine.last_ask_ranked = None
    assert t._ask_filtered(2, t.history) == [cands[3], cands[4]]
    # ranked head longer than want: filter picks within the head only;
    # the fill tail (cands[4], the prior's favorite) is excluded
    t.engine.last_ask_ranked = 4
    assert t._ask_filtered(2, t.history) == [cands[2], cands[3]]
    # ranked head shorter than want: the whole head survives unfiltered
    # and fills only top up the deficit, in engine order
    t.engine.last_ask_ranked = 1
    assert t._ask_filtered(2, t.history) == [cands[0], cands[1]]
    t.close()


def test_warm_bo_reports_ranked_head_when_padding():
    """BayesOpt's transfer ask marks where acquisition-ranked candidates
    end and random fills begin."""
    space = SearchSpace.from_dicts([
        {"type": "int", "name": "inter_op", "min": 1, "max": 6}])
    pts = [dict(p) for p in space.enumerate()]
    prior = _prior_from(space, [(p, float(p["inter_op"])) for p in pts])
    eng = BayesOpt(space, seed=0, transfer_prior=prior)
    h = History(space)
    for p in pts[:3]:
        v = float(p["inter_op"])
        eng.tell([Observation(point=p, value=v)])
        h.add(p, v)
    batch = eng.ask(5, h)
    assert len(batch) == 5
    # 3 unseen grid points were acquisition-ranked; 2 were random fills
    assert eng.last_ask_ranked == 3


def test_exhaustive_sweep_is_never_prefiltered(tmp_path):
    """Exhaustive's asks consume a one-shot grid iterator: a pre-filtered
    point would never be re-proposed, so an 'exhaustive' sweep with a
    corpus attached (the service attaches one to every job) would
    silently skip grid points — it must opt out and still cover the
    whole grid."""
    from repro_torch.core.exhaustive import Exhaustive

    assert Exhaustive.prefilter_safe is False

    corpus_path = tmp_path / "corpus.json"
    space = SearchSpace.from_dicts([
        {"type": "int", "name": "inter_op", "min": 1, "max": 4},
        {"type": "cat", "name": "build", "choices": [0, 1, 2]},
    ])
    feats = {"flops": 1e12}
    pts = [dict(p) for p in space.enumerate()]
    _populate(corpus_path, "donor", feats,
              [(p, float(i)) for i, p in enumerate(pts)], space=space)

    obj = FeaturedObjective(feats, value_fn=lambda p: float(p["inter_op"]))
    t = Tuner(obj, space,
              TunerConfig(algorithm="exhaustive", budget=len(pts) + 5,
                          seed=0, verbose=False,
                          transfer=TransferConfig(
                              corpus_path=str(corpus_path), job_id="sweep")))
    assert t._transfer_prior is not None  # the prior exists...
    assert not t._prefilter_on            # ...but exhaustive opts out
    h = t.run()
    t.close()
    # every grid point was measured exactly once — nothing skipped
    assert sorted(space.key(p) for p in h.points()) \
        == sorted(space.key(p) for p in pts)


def test_transfer_config_roundtrip_and_unknown_key_rejection():
    cfg = TunerConfig(algorithm="bo", budget=5,
                      transfer=TransferConfig(corpus_path="c.json",
                                              keep_fraction=0.25))
    d = cfg.to_dict()
    assert d["transfer"]["corpus_path"] == "c.json"
    back = TunerConfig.from_dict(d)
    assert back.transfer.to_dict() == cfg.transfer.to_dict()
    assert bool(back.transfer)
    assert not bool(TunerConfig(algorithm="bo", budget=5).transfer)
    with pytest.raises(ValueError, match="keep_fractoin"):
        TunerConfig.from_dict(
            {"algorithm": "bo", "budget": 5,
             "transfer": {"corpus_path": "c.json", "keep_fractoin": 0.5}})


def test_legacy_tell_signature_still_warns():
    """The deprecation shim stays behaviorally exact while every package-
    internal caller is held to the Observation API by the pytest
    ``filterwarnings = error::DeprecationWarning:repro`` gate."""
    from repro_torch.core import ENGINES

    space = golden_space()
    eng = ENGINES["random"](space, seed=0)
    p = {"inter_op": 1, "intra_op": 0, "build": 1}
    with pytest.warns(DeprecationWarning, match="pass a sequence of"):
        eng.tell([p], [1.5], [0.25])
    assert eng.mean_cost_seconds == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# executor hooks
# ---------------------------------------------------------------------------

def test_executor_records_real_measurements_only(tmp_path):
    space = golden_space()
    corpus = TuningCorpus(tmp_path / "corpus.json", job_id="exec")
    obj = FeaturedObjective({"flops": 1e12})
    ex = EvaluationExecutor(obj, space, parallelism=1, corpus=corpus)
    assert corpus.descriptor is not None  # executor bound the descriptor
    p1 = {"inter_op": 1, "intra_op": 0, "build": 1}
    p2 = {"inter_op": 2, "intra_op": 5, "build": 2}
    ex.evaluate([p1, p2])
    ex.evaluate([p1])  # memo hit: must NOT be re-recorded
    ex.close()
    recs = TuningCorpus(tmp_path / "corpus.json", job_id="other").records()
    assert len(recs) == 2
    assert {tuple(space.key(r["point"])) for r in recs} \
        == {space.key(p1), space.key(p2)}
    assert all(r["workload"]["job_id"] == "exec" for r in recs)


# ---------------------------------------------------------------------------
# strict grid-key serialization (the default=str regression)
# ---------------------------------------------------------------------------

def test_store_key_coerces_numpy_scalars_losslessly():
    """Numpy scalars (a space built from np.linspace / np.arange values)
    canonicalize via .item(): the store key is byte-identical to the
    plain-Python spelling, so memoization keeps working for store and
    lookup alike instead of hard-failing at persist time."""
    assert _store_key((np.int64(3), "x")) == _store_key((3, "x"))
    assert _store_key((np.float64(0.5), np.bool_(True))) \
        == _store_key((0.5, True))
    # and inside the (tuple-shaped) fidelity marker
    assert _store_key(memo_key(("a", np.int64(2)), np.float64(0.25))) \
        == _store_key(memo_key(("a", 2), 0.25))


def test_store_key_rejects_non_json_components():
    """TypeError is reserved for genuinely non-JSON objects."""
    with pytest.raises(TypeError, match="not strictly JSON-serializable"):
        _store_key((object(), 1))


def test_store_key_roundtrips_fidelity_marker():
    key = memo_key(("a", 2, 1), 0.25)
    skey = _store_key(key)
    assert json.loads(skey)[-1] == ["__fidelity__", 0.25]
    assert MemoCache._stored_fidelity(skey) == 0.25
    full = _store_key(memo_key(("a", 2, 1), None))
    assert MemoCache._stored_fidelity(full) is None


def test_memo_cache_numpy_key_memoizes_to_same_slot(tmp_path):
    from repro_torch.tuning.cache import JsonCacheStore

    path = tmp_path / "memo.json"
    cache = MemoCache(store=JsonCacheStore(path))
    cache.put((np.int64(3), "x"), EvalResult({"a": 1}, 2.0, 0.1, {}))
    cache.put((3, "x"), EvalResult({"a": 1}, 2.0, 0.1, {}))
    # numpy and plain spellings hash/compare equal in memory and collapse
    # to ONE canonical store key on disk — not a colliding pair
    assert cache.get((3, "x")).value == 2.0
    on_disk = json.loads(path.read_text())
    assert list(on_disk) == [_store_key((3, "x"))]
