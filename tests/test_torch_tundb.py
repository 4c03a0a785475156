"""The port's TuningDB against the reference's: same bucketing, keep-best,
record format and file; fingerprints that never meet; and the serve step
picking tuned tiles up through the memoised ``_tuned``."""
import json
import pathlib

import pytest
import torch

import repro_torch.kernels.ops as ops
from repro.tuning.tundb import TuningDB as RefTuningDB
from repro.tuning.tundb import bucket_shape as ref_bucket_shape
from repro.tuning.tundb import hardware_fingerprint as ref_fingerprint
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params
from repro_torch.models.runtime import CPU_TEST, Runtime
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.tuning.tundb import TuningDB, bucket_shape, hardware_fingerprint

FP = {"backend": "cpu", "device_kind": "cpu", "device_count": 1,
      "machine": "x86_64", "cpu_count": 8}


@pytest.mark.parametrize("dims", [{"S": 1}, {"S": 3}, {"S": 4},
                                  {"S": 3000, "B": 7}, {"S": 0, "w": -1},
                                  {"rows": 4096, "D": 896}])
def test_bucket_shape_equals_reference(dims):
    assert bucket_shape(dims) == ref_bucket_shape(dims)
    assert bucket_shape({"S": 3000, "B": 7}) == {"S": 4096, "B": 8}


def test_record_keeps_best_value():
    db = TuningDB(fingerprint=FP)
    assert db.record("k", {"S": 8}, {"chunk": 8}, 5.0)
    assert not db.record("k", {"S": 8}, {"chunk": 4}, 4.0)  # worse: kept out
    assert not db.record("k", {"S": 8}, {"chunk": 2}, 5.0)  # tie: kept out
    assert db.kernel_config("k", {"S": 8}) == {"chunk": 8}
    assert db.record("k", {"S": 8}, {"chunk": 16}, 6.0)  # strict improvement
    assert db.kernel_config("k", {"S": 8}) == {"chunk": 16}


def test_hit_miss_and_fingerprint_scoping():
    db = TuningDB(fingerprint=FP)
    db.record("rmsnorm", {"rows": 100, "D": 64}, {"block_rows": 32}, 10.0)
    assert db.kernel_config("rmsnorm", {"rows": 65, "D": 64}) == {"block_rows": 32}
    assert db.kernel_config("rmsnorm", {"rows": 128, "D": 129}) is None
    other = TuningDB(store=db.store, fingerprint=dict(FP, device_count=4))
    other.refresh()
    assert other.lookup("rmsnorm", {"rows": 100, "D": 64}) is None
    assert other.lookups == 1 and other.hits == 0
    with pytest.raises(ValueError):
        TuningDB("x.json", store=db.store)


def test_persisted_db_round_trips(tmp_path):
    path = str(tmp_path / "tundb.json")
    db = TuningDB(path, fingerprint=FP)
    db.record("rmsnorm", {"rows": 64, "D": 64}, {"block_rows": 16}, 2.0,
              fidelity=0.5, job_id="job-1", timestamp=123.0)
    assert len(json.loads(pathlib.Path(path).read_text())) == 1
    rec = TuningDB(path, fingerprint=FP).lookup("rmsnorm", {"rows": 64, "D": 64})
    assert rec["fidelity"] == 0.5 and rec["job_id"] == "job-1"
    assert rec["timestamp"] == 123.0 and rec["bucket"] == {"rows": 64, "D": 64}


def test_both_packages_write_the_same_key_and_read_each_others_file(tmp_path):
    dims = {"B": 1, "Sq": 100, "Sk": 100, "H": 4, "K": 2, "dh": 16}
    assert TuningDB(fingerprint=FP)._key("flash_attention", bucket_shape(dims)) == \
        RefTuningDB(fingerprint=FP)._key("flash_attention", ref_bucket_shape(dims))

    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    TuningDB(a, fingerprint=FP).record(
        "flash_attention", dims, {"block_q": 32, "block_kv": 64}, 7.0,
        job_id="j", timestamp=1.0)
    RefTuningDB(b, fingerprint=FP).record(
        "flash_attention", dims, {"block_q": 32, "block_kv": 64}, 7.0,
        job_id="j", timestamp=1.0)
    assert json.loads(pathlib.Path(a).read_text()) == json.loads(pathlib.Path(b).read_text())
    assert RefTuningDB(a, fingerprint=FP).kernel_config("flash_attention", dims) == \
        {"block_q": 32, "block_kv": 64}
    assert TuningDB(b, fingerprint=FP).kernel_config("flash_attention", dims) == \
        {"block_q": 32, "block_kv": 64}


def test_default_fingerprints_never_meet(tmp_path):
    fp, rfp = hardware_fingerprint("cpu"), ref_fingerprint()
    assert fp != rfp
    assert {"backend", "device_kind", "compute_capability", "device_count",
            "torch", "cuda", "machine", "cpu_count"} == set(fp)
    assert fp["backend"] == "cpu" and fp["torch"] == str(torch.__version__)
    # a record taken by the reference never configures the port, nor the reverse
    path = str(tmp_path / "shared.json")
    RefTuningDB(path).record("rmsnorm", {"rows": 8, "D": 64}, {"block_rows": 4}, 1.0)
    db = TuningDB(path, fingerprint=hardware_fingerprint("cpu"))
    assert len(db) == 1 and db.kernel_config("rmsnorm", {"rows": 8, "D": 64}) is None
    db.record("rmsnorm", {"rows": 8, "D": 64}, {"block_rows": 2}, 1.0)
    assert RefTuningDB(path).kernel_config("rmsnorm", {"rows": 8, "D": 64}) == {"block_rows": 4}


def test_db_is_identity_hashable_and_runtime_carries_none_by_default():
    import dataclasses
    db, db2 = TuningDB(fingerprint=FP), TuningDB(fingerprint=FP)
    assert db != db2 and db == db and hash(db) == hash(db)
    rt = dataclasses.replace(CPU_TEST, tuning_db=db)
    hash(rt)
    assert rt != dataclasses.replace(CPU_TEST, tuning_db=db2)
    assert Runtime().tuning_db is None and CPU_TEST.tuning_db is None


def _spy_tuned(monkeypatch):
    seen = {}
    orig = ops._tuned

    def spy(db, kernel, dims, defaults):
        out = orig(db, kernel, dims, defaults)
        if db is not None:
            seen[kernel] = {"dims": dict(dims), "chosen": dict(out)}
        return out

    monkeypatch.setattr(ops, "_tuned", spy)
    return seen


@pytest.fixture
def tiny_lm():
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg)
    params, _ = split_params(model.init(torch.Generator().manual_seed(0)))
    return cfg, model, params


def test_serve_step_picks_up_tuned_tiles(monkeypatch, tiny_lm):
    cfg, model, params = tiny_lm
    # impl="cuda" on CPU tensors: the kernels' plain versions, same dispatch
    rt = Runtime(compute_dtype="f32", attn_impl="cuda")
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32)}

    seen = _spy_tuned(monkeypatch)
    db = TuningDB(fingerprint=hardware_fingerprint("cpu"))
    cache, _ = split_params(model.init_cache(1, 32))
    logits0, _ = make_prefill_step(model, rt, tuning_db=db)(params, batch, cache)
    dims = seen["flash_attention"]["dims"]
    assert dims == {"B": 1, "Sq": 16, "Sk": 16, "H": 4, "K": 2, "dh": 16}
    assert seen["flash_attention"]["chosen"] == {"block_q": rt.block_q,
                                                 "block_kv": rt.block_kv}
    assert seen["rmsnorm"]["dims"] == {"rows": 1, "D": 64}  # the last norm: the head's
    assert db.lookups > 0 and db.hits == 0
    assert flash_attention.last_config == {"block_q": 16, "block_kv": 16}

    db.record("flash_attention", dims, {"block_q": 8, "block_kv": 8}, 99.0)
    seen.clear()
    cache, _ = split_params(model.init_cache(1, 32))
    logits1, _ = make_prefill_step(model, rt, tuning_db=db)(params, batch, cache)
    assert seen["flash_attention"]["chosen"] == {"block_q": 8, "block_kv": 8}
    assert flash_attention.last_config == {"block_q": 8, "block_kv": 8}
    assert db.hits > 0
    torch.testing.assert_close(logits1, logits0, atol=1e-5, rtol=1e-5)


def test_no_db_consults_nothing(monkeypatch, tiny_lm):
    cfg, model, params = tiny_lm
    rt = Runtime(compute_dtype="f32", attn_impl="cuda")
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32)}
    cache, _ = split_params(model.init_cache(1, 32))
    seen = _spy_tuned(monkeypatch)
    make_prefill_step(model, rt)(params, batch, cache)
    assert seen == {}  # tuning_db=None: the spy records only real consults


def test_memoised_lookup_consults_once_per_kernel_and_dims(tiny_lm):
    cfg, model, params = tiny_lm
    rt = Runtime(compute_dtype="f32", attn_impl="cuda")
    db = TuningDB(fingerprint=hardware_fingerprint("cpu"))
    prefill = make_prefill_step(model, rt, tuning_db=db)
    decode = make_decode_step(model, rt, tuning_db=db)
    assert db.lookups == 0
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
    cache, _ = split_params(model.init_cache(2, 32))
    logits, cache = prefill(params, batch, cache)
    # 2 layers: flash (one shape), rmsnorm at rows=32 (blocks) and rows=2 (head)
    assert db.lookups == 3
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(3):
        logits, cache = decode(params, tok, cache)
    # decode adds decode_attention (one shape); rmsnorm rows=2 is known already
    assert db.lookups == 4
    # a rebuilt step reads the DB anew
    make_prefill_step(model, rt, tuning_db=db)(
        params, batch, split_params(model.init_cache(2, 32))[0])
    assert db.lookups == 7
    ops.forget_tuned()
