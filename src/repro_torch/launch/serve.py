"""Serving entry point: batched prefill + decode in packed waves.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --no-reduced --dtype bf16 --requests 16 --prompt-len 512 \
        --gen-len 64 --batch 8

Requests arrive with ragged prompt lengths; the scheduler packs them into
fixed decode batches (left-padded), prefills, then decodes until every
request has ``gen_len`` tokens, wave after wave.

Runs on the card (``--device cuda``, the default) through the hand-written
kernels (``runtime``: attention, RMSNorm and the scans), and raises when
there is no card.  On the card every family prefills and decodes through
the compiled steps, as the reference does through ``jax.jit``:
``make_graphed_prefill_step`` (one CUDA graph a ``(batch, prompt_len,
cache_len)``, captured at the second wave and replayed at every later
one) and ``make_graphed_decode_step`` (one graph a ``(batch,
cache_len)``, captured at the second token and replayed at every later
one); a capture that fails raises.  ``--device cpu`` is for tests: it
takes the oracles and prefills and decodes eagerly.  The cache is
allocated once and zeroed in place at the start of every wave, so each
wave starts from a fresh cache's state at the addresses the graphs hold.
An encoder-decoder model (whisper) gets zero ``encoder_embeds`` of
``encoder_seq_len`` frames, a VLM zero ``image_embeds``, as in the
reference.
Beyond the flags of the reference package's script: ``--device``, ``--dtype``,
``--no-reduced`` (the reference's ``--reduced`` cannot be switched off) and
``--trace``: the program's spans on (``runtime/trace_hooks.py``; the wave
loop's ``wave.admit``, ``wave.prefill``, ``wave.decode`` and
``wave.readback`` around the steps' own), and one ``[trace]`` line a span
after the ``[serve]`` line.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params
from repro_torch.models.runtime import Runtime
from repro_torch.runtime import trace_hooks
from repro_torch.serve.serve_step import (greedy_sample, make_decode_step,
                                          make_graphed_decode_step, make_graphed_prefill_step,
                                          make_prefill_step, reset_cache)


def runtime(on_card: bool, dtype: str) -> Runtime:
    """The served runtime: on the card every kernel of the path (attention,
    decode attention, RMSNorm, the scans in a ``full`` forward, and K5 in
    RWKV's prefill, where it also writes the state); on the CPU the
    oracles."""
    impl = "cuda" if on_card else "ref"
    return Runtime(compute_dtype=dtype, attn_impl=impl,
                   scan_impl="cuda" if on_card else "chunked")


def frontend_inputs(cfg, B: int, device) -> dict:
    """The stub frontends' zero embeddings a batch of ``cfg`` carries."""
    batch = {}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.zeros(
            (B, cfg.num_frontend_tokens, cfg.d_model), device=device)
    if cfg.encoder_layers:
        batch["encoder_embeds"] = torch.zeros(
            (B, cfg.encoder_seq_len, cfg.d_model), device=device)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="tiny same-family config (default); --no-reduced "
                         "serves the architecture at its published width")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="compute dtype; the weights are cast to it once")
    ap.add_argument("--tuning-db", default=None, metavar="PATH",
                    help="persisted TuningDB; tuned kernel tiles are picked "
                         "up when the steps are built")
    ap.add_argument("--trace", action="store_true",
                    help="record the program's spans and print one [trace] line a span")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda (the default) needs an NVIDIA GPU and none is "
            "visible; pass --device cpu to run the oracles on the CPU")
    device = torch.device(args.device)
    on_card = device.type == "cuda"

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    rt = runtime(on_card, args.dtype)
    tuning_db = None
    if args.tuning_db:
        from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint
        tuning_db = TuningDB(args.tuning_db,
                             fingerprint=hardware_fingerprint(device.type))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # cast once, block by block: the steps then find every weight in the
    # compute dtype
    params, _ = split_params(model.init(gen, dtype=rt.dtype()))

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=rng.integers(args.prompt_len // 2,
                                                          args.prompt_len + 1))
        for _ in range(args.requests)
    ]

    prefill = (make_graphed_prefill_step if on_card else make_prefill_step)(
        model, rt, tuning_db=tuning_db)
    decode = (make_graphed_decode_step if on_card else make_decode_step)(
        model, rt, tuning_db=tuning_db)
    cache_len = args.prompt_len + args.gen_len
    cache, _ = split_params(model.init_cache(args.batch, cache_len, device=device))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    if args.trace:
        trace_hooks.reset()
        trace_hooks.tracing(True)
    try:
        span = lambda name: trace_hooks.span(name, card=on_card)  # noqa: E731
        sync()
        done, t0, tokens_out = [], time.perf_counter(), 0
        queue = list(enumerate(prompts))
        while queue:
            wave = queue[: args.batch]
            queue = queue[args.batch:]
            B = args.batch
            with span("wave.admit"):
                toks = np.zeros((B, args.prompt_len), np.int32)
                for i, (_, p) in enumerate(wave):  # left-pad to a packed batch
                    toks[i, args.prompt_len - len(p):] = p
                batch = {"tokens": torch.from_numpy(toks).to(device),
                         **frontend_inputs(cfg, B, device)}
                cache = reset_cache(cache)
            with span("wave.prefill"):
                logits, cache = prefill(params, batch, cache)
                tok = greedy_sample(logits)
            outs = [tok]
            with span("wave.decode"):
                for _ in range(args.gen_len - 1):
                    logits, cache = decode(params, tok, cache)
                    tok = greedy_sample(logits)
                    outs.append(tok)
            with span("wave.readback"):
                gen_toks = torch.cat(outs, dim=1).cpu().numpy()  # waits for the device
            tokens_out += int(gen_toks.size)
            for i, (rid, _) in enumerate(wave):
                done.append((rid, gen_toks[i]))

        sync()
    finally:
        if args.trace:
            trace_hooks.tracing(False)
    dt = time.perf_counter() - t0
    print(f"[serve] {len(done)} requests, {tokens_out} tokens in {dt:.2f}s "
          f"=> {tokens_out/dt:.1f} tok/s (greedy, batch={args.batch})")
    if args.trace:
        for line in trace_hooks.summary():
            print(line)
    return done


if __name__ == "__main__":
    main()
