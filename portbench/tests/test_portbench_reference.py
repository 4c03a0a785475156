"""Each plain reference agrees with the program's CPU path (its oracles, in
float32) at a reduced size, on the benchmark's own weights."""
import pytest
import torch

from portbench import weights
from portbench.reference import adamw, qwen, rwkv

QWEN = {"name": "q", "family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 2, "d_ff": 128, "vocab_size": 300, "head_dim": 16, "qkv_bias": True,
        "rope_theta": 1e6, "tie_embeddings": True}
RWKV = {"name": "r", "family": "ssm", "num_layers": 2, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 4, "d_ff": 128, "vocab_size": 256, "head_dim": 16,
        "rwkv": {"head_size": 16, "decay_lora": 8, "mix_lora": 8}}


def _program(port):
    from repro_torch.models.model import build_model
    from repro_torch.models.runtime import Runtime

    from portbench import spec

    model = build_model(spec.model_config({"port": port}))
    return model, Runtime(compute_dtype="f32", attn_impl="ref", scan_impl="chunked", scan_chunk=8)


def _tokens(B, S, V, seed=0):
    return torch.randint(1, V, (B, S), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("port,ref", [(QWEN, qwen), (RWKV, rwkv)], ids=["qwen", "rwkv"])
def test_the_weights_are_the_program_layout(port, ref):
    from repro_torch.models.params import split_params

    model, _ = _program(port)
    theirs = weights.leaves(split_params(model.init(torch.Generator().manual_seed(0)))[0])
    ours = weights.leaves(weights.make({"port": port}, 3, torch.float32, "cpu"))
    assert list(theirs) == list(ours)
    assert all(theirs[k].shape == ours[k].shape for k in ours)
    again = weights.leaves(weights.make({"port": port}, 3, torch.float32, "cpu"))
    assert all(torch.equal(ours[k], again[k]) for k in ours)
    assert float(ours["embed"][port["vocab_size"]:].abs().sum()) == 0.0


@pytest.mark.parametrize("port,ref", [(QWEN, qwen), (RWKV, rwkv)], ids=["qwen", "rwkv"])
def test_full_forward(port, ref):
    model, rt = _program(port)
    w = weights.make({"port": port}, 5, torch.float32, "cpu")
    toks = _tokens(2, 19, 256)
    theirs = model.apply(w, {"tokens": toks}, rt=rt)[0]
    ours = ref.logits(w, port, toks)
    torch.testing.assert_close(ours, theirs.float(), rtol=1e-4, atol=1e-4)


def test_rwkv_served_tokens():
    """Prefill, then decode steps through the recurrent state, against one
    pass over prompt and served tokens."""
    from repro_torch.models.params import split_params
    from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

    model, rt = _program(RWKV)
    w = weights.make({"port": RWKV}, 6, torch.float32, "cpu")
    toks = _tokens(2, 13, 256, 1)
    cache = split_params(model.init_cache(2, 20))[0]
    logits, cache = make_prefill_step(model, rt)(w, {"tokens": toks}, cache)
    outs, seq = [logits[:, -1]], [greedy_sample(logits)]
    decode = make_decode_step(model, rt)
    for _ in range(4):
        logits, cache = decode(w, seq[-1], cache)
        outs.append(logits[:, -1])
        seq.append(greedy_sample(logits))
    full = torch.cat([toks] + seq[:-1], dim=1)
    ours = rwkv.logits(w, RWKV, full, at=torch.arange(12, 17))
    torch.testing.assert_close(ours, torch.stack(outs, 1).float(), rtol=1e-4, atol=1e-4)


def test_qwen_after_a_cached_context():
    """Decode steps after a prefill, against the reference handed the
    prefill's cached keys and values (stored in bf16, as the program stores
    them: the new tokens' keys and values are rounded there too, hence the
    looser tolerance)."""
    from repro_torch.models.params import split_params
    from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

    model, rt = _program(QWEN)
    w = weights.make({"port": QWEN}, 8, torch.float32, "cpu")
    P = 11
    toks = _tokens(2, P, 300, 2)
    cache = split_params(model.init_cache(2, 20))[0]
    logits, cache = make_prefill_step(model, rt)(w, {"tokens": toks}, cache)
    mixer = cache["layers"]["pos0"]["mixer"]
    ctx = (mixer["k"][:, :, :P].clone(), mixer["v"][:, :, :P].clone())
    tok, outs, seq = greedy_sample(logits), [], []
    decode = make_decode_step(model, rt)
    for _ in range(4):
        seq.append(tok)
        logits, cache = decode(w, tok, cache)
        outs.append(logits[:, -1])
        tok = greedy_sample(logits)
    ours = qwen.logits(w, QWEN, torch.cat(seq, 1), first=P,
                       context=lambda l: (ctx[0][l], ctx[1][l]))
    torch.testing.assert_close(ours, torch.stack(outs, 1).float(), rtol=0, atol=3e-2)


def test_rwkv_loss_and_gradients():
    from repro_torch.train.train_step import make_loss_fn, value_and_grad

    model, rt = _program(RWKV)
    w = weights.make({"port": RWKV}, 9, torch.float32, "cpu")
    toks, tgts = _tokens(2, 21, 256, 3), _tokens(2, 21, 256, 4)
    (loss, _), grads = value_and_grad(make_loss_fn(model, rt), w, {"tokens": toks, "targets": tgts})
    names = list(weights.leaves(w))
    params = [t.clone().requires_grad_(True) for t in weights.leaves(w).values()]
    tree = {}
    for n, p in zip(names, params):
        node = tree
        for k in n.split("/")[:-1]:
            node = node.setdefault(k, {})
        node[n.split("/")[-1]] = p
    ours = rwkv.loss(tree, RWKV, toks, tgts)
    ours_g = torch.autograd.grad(ours, params)
    torch.testing.assert_close(ours, loss, rtol=1e-5, atol=0)
    for n, g in zip(names, ours_g):
        torch.testing.assert_close(g, weights.leaves(grads)[n], rtol=1e-3, atol=1e-6, msg=n)


def test_adamw_follows_the_program_optimizer():
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init, adamw_update

    cfg = {"learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "grad_clip": 0.5, "warmup_steps": 2, "total_steps": 10,
           "min_lr_ratio": 0.1}
    g = torch.Generator().manual_seed(0)
    theirs = {"a": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g)}
    ours = [t.clone() for t in theirs.values()]
    state = adamw_init(theirs, OptimizerConfig(**cfg))
    opt = adamw.AdamW(cfg, ours)
    for _ in range(4):
        grads = {"a": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g)}
        theirs, state, _ = adamw_update(grads, state, theirs, OptimizerConfig(**cfg))
        opt.step(list(grads.values()))
    for t, o in zip(theirs.values(), ours):
        torch.testing.assert_close(o, t, rtol=1e-6, atol=1e-7)
