"""The decode branches with the position held on the device (a 0-d integer
tensor, as the compiled decode step keeps it) against the host-integer
position and against the reference, on the CPU, for every served family:
dense GQA, a sliding window past its ring wrap, MLA, RWKV-6, a Jamba
period (Mamba + MoE + attention) and the encoder-decoder.

After one prefill, both ports decode from equal copies of the cache: every
step's logits and the final cache equal bit for bit (``torch.equal``),
and the device-position logits stay within the reference's decode at the
family tests' tolerances (``test_torch_family_common.py``: f32, atol =
rtol = 2e-4).  While the device-position steps run, nothing reads a tensor
back to the host (``item``, ``int``, ``bool``, ``cpu`` ... raise) and the
host-keyed RoPE memo is never reached.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro.serve.serve_step import make_decode_step as ref_make_decode_step
from repro.serve.serve_step import make_prefill_step as ref_make_prefill_step
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import split_params, tree_leaves, tree_map
from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step
from test_torch_family_common import (TOL, batch_np, build_pair, jnp_batch, port_rt,
                                      ref_rt, to_numpy, torch_batch)

# (arch, prompt length, decode steps); danube's reduced window is 8 slots:
# its prompt of 12 wraps the ring at prefill and decode wraps it again
CASES = [("qwen2-0.5b", 10, 5), ("h2o-danube-1.8b", 12, 6), ("minicpm3-4b", 10, 4),
         ("rwkv6-3b", 10, 4), ("jamba-v0.1-52b", 10, 4), ("whisper-base", 10, 4)]
B = 2


def _jamba_period_pair():
    """One period of the reduced Jamba (Mamba, MoE and attention layers)."""
    rcfg = ref_configs.get_config("jamba-v0.1-52b").reduced()
    rcfg = dataclasses.replace(rcfg, num_layers=rcfg.layer_period())
    rmodel = ref_build_model(rcfg)
    rparams, _ = ref_split_params(rmodel.init(jax.random.PRNGKey(0)))
    cfg = get_config("jamba-v0.1-52b").reduced()
    cfg = dataclasses.replace(cfg, num_layers=cfg.layer_period())
    return dict(arch=cfg.name, rcfg=rcfg, rmodel=rmodel, rparams=rparams, cfg=cfg,
                model=build_model(cfg), params=params_from_numpy(to_numpy(rparams), device="cpu"))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    arch, S, steps = request.param
    pair = _jamba_period_pair() if arch == "jamba-v0.1-52b" else build_pair(arch)
    return pair, S, steps


class _HostReads(RuntimeError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Every way a tensor's value reaches the host raises."""
    names = ("item", "tolist", "cpu", "numpy", "__int__", "__index__", "__bool__",
             "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(name):
        def fn(self, *a, **kw):
            raise _HostReads(f"Tensor.{name} read the device on the host")
        return fn
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def _clone(cache):
    return {"pos": cache["pos"], "layers": tree_map(lambda t: t.clone(), cache["layers"])}


def _decode_both(pair, S, steps, monkeypatch):
    """Prefill once; decode ``steps`` tokens with the host position and,
    from an equal copy of the cache, with a device position.  Returns the
    logits of both, the greedy tokens, and both final caches."""
    cfg, model, params = pair["cfg"], pair["model"], pair["params"]
    b = batch_np(cfg, B, S, seed=2)
    cache, _ = split_params(model.init_cache(B, S + steps + 1))
    logits, cache = make_prefill_step(model, port_rt())(params, torch_batch(b), cache)
    host, dev = cache, _clone(cache)
    dev["pos"] = torch.tensor(dev["pos"])
    decode = make_decode_step(model, port_rt())
    rope_calls = []
    orig = L._rope_tables_cached
    monkeypatch.setattr(L, "_rope_tables_cached",
                        lambda *a: rope_calls.append(a) or orig(*a))
    tok = greedy_sample(logits)
    out_h, out_d, toks = [], [], [tok]
    for _ in range(steps):
        lh, host = decode(params, tok, host)
        with no_host_reads():
            n_before = len(rope_calls)
            ld, dev = decode(params, tok, dev)
            assert len(rope_calls) == n_before, "a device position reached the host memo"
        out_h.append(lh)
        out_d.append(ld)
        tok = greedy_sample(lh)
        toks.append(tok)
    return b, logits, out_h, out_d, toks, host, dev


def test_device_position_decode_is_the_host_decode_bit_for_bit(case, monkeypatch):
    pair, S, steps = case
    _, _, out_h, out_d, _, host, dev = _decode_both(pair, S, steps, monkeypatch)
    for t, (lh, ld) in enumerate(zip(out_h, out_d)):
        assert torch.equal(lh, ld), f"step {t}"
    assert isinstance(dev["pos"], torch.Tensor) and dev["pos"].dim() == 0
    assert int(dev["pos"]) == host["pos"] == S + steps
    for a, b in zip(tree_leaves(host["layers"]), tree_leaves(dev["layers"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_device_position_decode_matches_the_reference(case, monkeypatch):
    pair, S, steps = case
    b, logits, _, out_d, toks, _, _ = _decode_both(pair, S, steps, monkeypatch)
    rcache, _ = ref_split_params(pair["rmodel"].init_cache(B, S + steps + 1))
    rlogits, rcache = ref_make_prefill_step(pair["rmodel"], ref_rt())(
        pair["rparams"], jnp_batch(b), rcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    rdecode = ref_make_decode_step(pair["rmodel"], ref_rt())
    for t in range(steps):
        rlogits, rcache = rdecode(pair["rparams"], jnp.asarray(toks[t].numpy()), rcache)
        np.testing.assert_allclose(out_d[t].numpy(), np.asarray(rlogits), **TOL,
                                   err_msg=f"step {t}")
    assert int(rcache["pos"]) == S + steps


def test_device_position_derives_on_the_device():
    """Ring slot, lengths and tables from a 0-d tensor, made once a step."""
    p = L.DevicePosition(torch.tensor(11))
    assert torch.equal(p.slot(8, True), torch.tensor([3]))
    assert torch.equal(p.slot(16, False), torch.tensor([11]))
    assert p.slot(8, True).dtype == torch.int64
    assert torch.equal(p.lengths(3, 8), torch.full((3,), 8, dtype=torch.int32))
    assert torch.equal(p.lengths(3, 16), torch.full((3,), 12, dtype=torch.int32))
    assert p.lengths(3, 16) is p.lengths(3, 16)  # memoised for the step
    cos, sin = p.rope_tables(3, 16, 1e4)
    want = L._rope_tables_uncached(11, 1, 3, 16, 1e4, torch.device("cpu"))
    assert torch.equal(cos, want[0]) and torch.equal(sin, want[1])
    assert L.device_position(p) is p and L.device_position(7) == 7
    assert isinstance(L.device_position(torch.tensor(7, dtype=torch.int32)), L.DevicePosition)
    for bad in (torch.tensor([3]), torch.tensor(3.0), torch.tensor(True)):
        with pytest.raises(TypeError):
            L.DevicePosition(bad)


def test_device_position_write_is_the_slice_write():
    buf = torch.zeros(2, 6, 3, dtype=torch.bfloat16)
    want = buf.clone()
    v = torch.randn(2, 1, 3, generator=torch.Generator().manual_seed(0))
    L._write_seq(want, 4, v)
    L._write_seq(buf, torch.tensor([4]), v)
    assert torch.equal(buf, want) and buf.dtype == torch.bfloat16
