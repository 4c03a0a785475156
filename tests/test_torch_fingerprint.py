"""The TuningDB fingerprint names what was measured: the Triton version and
a revision of each kernel, hashed from its sources.  A record measured on
another build of a kernel misses, as a record of another machine does."""
import importlib.util
import shutil

import pytest

from repro_torch.tuning import tundb
from repro_torch.tuning.tundb import (KERNEL_NAMES, TuningDB, hardware_fingerprint,
                                      kernel_revisions)

DIMS = {"rmsnorm": {"rows": 4096, "D": 896},
        "flash_attention": {"B": 8, "Sq": 512, "Sk": 512, "H": 14, "K": 2, "dh": 64}}


def test_fingerprint_has_triton_and_kernel_revisions():
    fp = hardware_fingerprint("cpu")
    if importlib.util.find_spec("triton") is None:
        assert fp["triton"] is None
    else:
        assert isinstance(fp["triton"], str)
    assert fp["kernel_revisions"] == kernel_revisions()
    assert sorted(fp["kernel_revisions"]) == sorted(KERNEL_NAMES)
    assert len(set(fp["kernel_revisions"].values())) == len(KERNEL_NAMES)


def test_revision_follows_the_kernels_own_sources(tmp_path, monkeypatch):
    copy = tmp_path / "kernels"
    shutil.copytree(tundb._KERNELS_DIR, copy)
    monkeypatch.setattr(tundb, "_KERNELS_DIR", copy)
    before = kernel_revisions()
    assert before == kernel_revisions()  # deterministic
    with open(copy / "csrc" / "flash_attention.cu", "a") as f:
        f.write("// another build\n")
    after = kernel_revisions()
    assert after["flash_attention"] != before["flash_attention"]
    assert {k: v for k, v in after.items() if k != "flash_attention"} == \
        {k: v for k, v in before.items() if k != "flash_attention"}
    with open(copy / "rmsnorm.py", "a") as f:  # K1 is its Triton wrapper alone
        f.write("# another build\n")
    assert kernel_revisions()["rmsnorm"] != before["rmsnorm"]


@pytest.mark.parametrize("redesigned", ["rmsnorm", "flash_attention"])
def test_db_of_another_kernel_revision_misses(tmp_path, redesigned):
    path = str(tmp_path / "db.json")
    fp = hardware_fingerprint("cpu")
    old = TuningDB(path, fingerprint=fp)
    old.record("rmsnorm", DIMS["rmsnorm"], {"block_rows": 8}, 1.0)
    old.record("flash_attention", DIMS["flash_attention"], {"block_q": 64, "block_kv": 64}, 1.0)

    same = TuningDB(path, fingerprint=fp)
    assert all(same.lookup(k, d) is not None for k, d in DIMS.items())

    revs = dict(fp["kernel_revisions"], **{redesigned: "0" * 16})
    new = TuningDB(path, fingerprint=dict(fp, kernel_revisions=revs))
    for kernel, dims in DIMS.items():
        hit = new.lookup(kernel, dims)
        assert (hit is None) == (kernel == redesigned), kernel
    assert new.kernel_config(redesigned, DIMS[redesigned]) is None


def test_db_of_another_triton_misses():
    fp = hardware_fingerprint("cpu")
    db = TuningDB(fingerprint=fp)
    db.record("rmsnorm", DIMS["rmsnorm"], {"block_rows": 8}, 1.0)
    other = TuningDB(store=db.store, fingerprint=dict(fp, triton="0.0.0"))
    assert other.lookup("rmsnorm", DIMS["rmsnorm"]) is None
