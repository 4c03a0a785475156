"""The program's spans and counters (``runtime/trace_hooks.py``).

On the CPU:

* Off (no switch, no profiler): a compiled call (under an emulated graph)
  and an eager train step make no record, no ``record_function`` range and
  no ``torch.cuda.Event``.
* On, by the switch and by a recording ``torch.profiler``: a compiled
  step's records arrive in call order, with its binding check inside each,
  and its calls counted by kind (1 eager, 1 capture, n - 2 replays after n
  calls).  The tuner's measured step is no span, nor are the spans of its
  captured region.
* A train step's phases are recorded in order, one record a phase a step,
  summed over the microbatches; inside a compiled step they are timed by
  the events captured into its graph, each replay's times read before the
  next replay records the events again (stand-in events and graph).
* A record's host start is on the profiler's clock: within 1 ms of its
  ``repro_torch.<name>`` range among the profiler's events.  The range is
  no user annotation, which the profiler would copy onto the device's
  timeline.
* ``launch/serve.py --device cpu --trace`` and ``launch/train.py --trace``
  print their ``[trace]`` lines, and their ``[serve]`` / ``[train]`` lines
  are those of a run without ``--trace``.

On the card (``card``; skipped here): a compiled train step's three phases
sum to within 2 % of its replay's device time; tracing on leaves the
compiled decode, prefill and train steps' outputs bit for bit; a capture
in a traced window shows in the ``capture`` counter.

    python -m pytest -q tests/test_torch_trace_spans.py -m card   # on the card

(The ``card`` marker is registered in ``pyproject.toml``.)
"""
import re
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.params import split_params, tree_leaves
from repro_torch.models.runtime import Runtime
from repro_torch.optim import optimizer as O
from repro_torch.runtime import graphs as G
from repro_torch.runtime import trace_hooks as T
from repro_torch.serve import serve_step as SS
from repro_torch.train import train_step as TS

RT = Runtime(compute_dtype="f32")
OPT = O.OptimizerConfig(learning_rate=1e-2, warmup_steps=3, total_steps=8)
B, S, CACHE_LEN = 2, 6, 16
LINE = re.compile(r"^\[trace\] (\S+) calls (\d+) host_ms (mean \S+ p95 \S+|-) "
                  r"device_ms (mean \S+|-)( eager (\d+) capture (\d+) replay (\d+))?$")


@pytest.fixture
def card():
    """The card, decided inside the test (never at import or collection):
    a ``card`` test skips with a reason where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh():
    T.reset()
    prev = T.tracing(False)
    yield
    T.tracing(prev)
    T.reset()


def _model(arch="qwen2-0.5b"):
    model = build_model(get_config(arch).reduced())
    params, _ = split_params(model.init(torch.Generator().manual_seed(0)))
    return model, params


def _train_batch(model, step, batch=4, seq=8):
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=seq,
                                      global_batch=batch))
    return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}


# -- a stand-in graph and stand-in timing events ----------------------------------------------


class _Clock:
    now = 0.0
    tick = 1.0


class _Event:
    """A timing event on a stand-in clock: ``record`` reads the clock and
    moves it on by one tick; the events made for a graph (``external``)
    are kept, in order, so that a replay records them again."""

    external = []

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        if external:
            _Event.external.append(self)

    def record(self):
        _Clock.now += _Clock.tick
        self.t = _Clock.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


class _Graph:
    """``StepGraph`` on the CPU: ``eager`` runs the step, ``capture`` runs the
    region once (``capturing`` meanwhile), ``replay`` runs no Python of the
    step and records the graph's events again, the k-th replay at a tick
    of k ms."""

    capturing = False

    def __init__(self, name, what, device):
        self.graph = None
        self.eagers = self.replays = 0

    def eager(self, fn):
        self.eagers += 1
        return fn()

    def capture(self, region):
        _Graph.capturing = True
        try:
            out = region()
        finally:
            _Graph.capturing = False
        self.graph = "captured"
        return out

    def replay(self):
        self.replays += 1
        _Clock.tick = float(self.replays)
        for e in _Event.external:
            e.record()

    def release(self):
        self.graph = None


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(G, "require_card", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(G, "StepGraph", _Graph)
    _Event.external, _Clock.now, _Clock.tick = [], 0.0, 1.0


def _decode_calls(n):
    model, params = _model()
    cache = split_params(model.init_cache(B, CACHE_LEN))[0]
    step = SS.make_graphed_decode_step(model, RT)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    c = {"pos": 3, "layers": cache["layers"]}
    for _ in range(n):
        _, c = step(params, tok, c)
    return "serve.decode"


def _prefill_calls(n):
    model, params = _model()
    cache = split_params(model.init_cache(B, CACHE_LEN))[0]
    step = SS.make_graphed_prefill_step(model, RT)
    batch = {"tokens": torch.ones((B, S), dtype=torch.int32)}
    for _ in range(n):
        step(params, batch, SS.reset_cache(cache))
    return "serve.prefill"


def _train_calls(n, microbatches=1):
    model, params = _model()
    state = O.adamw_init(params, OPT)
    step = TS.make_graphed_train_step(model, OPT, RT, microbatches)
    for i in range(n):
        step(params, state, _train_batch(model, i))
    return "train.step"


def _eager_train_calls(n, microbatches=1):
    model, params = _model()
    state = O.adamw_init(params, OPT)
    step = TS.make_train_step(model, OPT, RT, microbatches, donate=True)
    for i in range(n):
        step(params, state, _train_batch(model, i))
    return None


COMPILED = {"decode": _decode_calls, "prefill": _prefill_calls, "train": _train_calls}


# -- off -------------------------------------------------------------------------------------


@pytest.mark.parametrize("calls", ["decode", "prefill", "train", "eager train"])
def test_off_makes_no_event_no_range_and_no_record(calls, emulated, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span that is off made an event or a range")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch._C._autograd._profiler_enabled()
    {**COMPILED, "eager train": _eager_train_calls}[calls](3)
    assert T.counters() == {} and T.summary() == []
    for name in ("serve.decode", "serve.prefill", "train.step", "train.forward"):
        assert T.records(name) == []


# -- on --------------------------------------------------------------------------------------


@pytest.mark.parametrize("trigger", ["switch", "profiler"])
@pytest.mark.parametrize("calls", sorted(COMPILED))
def test_on_a_compiled_steps_calls_are_recorded_and_counted(calls, trigger, emulated):
    n = 5
    if trigger == "switch":
        T.tracing(True)
        name = COMPILED[calls](n)
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            name = COMPILED[calls](n)
        ranges = [e for e in prof.profiler.kineto_results.events()
                  if e.name() == T.PREFIX + name]
        assert len(ranges) == n
    recs = T.records(name)
    assert len(recs) == n
    starts = [r.start_ns for r in recs]
    assert starts == sorted(starts)
    assert all(r.host_ms > 0 and r.device_ms is None for r in recs)  # nothing on a card
    bind = T.records(name + ".bind")
    assert len(bind) == n
    assert all(a.start_ns <= b.start_ns and b.host_ms <= a.host_ms for a, b in zip(recs, bind))
    counts = T.counters()
    assert (counts[name], counts[name + ".eager"], counts[name + ".capture"],
            counts[name + ".replay"]) == (n, 1, 1, n - 2)


@pytest.mark.parametrize("trigger", ["switch", "profiler"])
def test_the_measured_step_is_no_span_nor_its_regions_spans(trigger, emulated, monkeypatch):
    """The tuner's measured step, whose time is its objective: traced or
    not, its calls make no record and no counter, and a span its region
    enters while the graph is captured is off (no timing event in the
    graph)."""
    def refuse(*a, **kw):
        raise AssertionError("the measured step's capture made a timing event")

    monkeypatch.setattr(T, "_capturing", lambda: _Graph.capturing)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    step = G.GraphedStep("rmsnorm", "measured step")
    args = (torch.ones(4, 8), torch.ones(8))
    eager = lambda: args[0] * args[1]  # noqa: E731

    def region(inputs):
        with T.span("train.forward", card=True):
            return eager()

    def calls():
        for _ in range(2):  # eager, then capture and a replay
            step.run({"arguments": args}, {}, eager, region)
        step.replay({})

    if trigger == "switch":
        T.tracing(True)
        calls()
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            calls()
    assert T.counters() == {} and T.summary() == []
    assert step._phases == []


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_phases_in_order_one_record_a_step_summed_over_microbatches(
        microbatches, monkeypatch):
    """An eager step on a stand-in host clock that moves one second a read:
    each phase's span lasts a second, so a phase's record holds a second a
    microbatch (the optimizer runs once)."""
    clock = iter(range(10**6))
    monkeypatch.setattr(T, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock)), time_ns=time.time_ns))
    T.tracing(True)
    _eager_train_calls(2, microbatches)
    want = {"train.forward": 1000.0 * microbatches, "train.backward": 1000.0 * microbatches,
            "train.optimizer": 1000.0}
    for name, ms in want.items():
        assert [r.host_ms for r in T.records(name)] == [ms, ms]
    for i in range(2):
        f, b, o = (T.records(n)[i] for n in want)
        assert f.start_ns <= b.start_ns <= o.start_ns
    assert T.counters() == {n: 2 for n in want}


def test_a_compiled_steps_phases_are_read_from_its_graph_after_each_replay(emulated,
                                                                           monkeypatch):
    """Two microbatches.  The capture (tracing off) records a pair of events
    a phase a microbatch into the graph; each traced replay then makes one
    record a phase, its device time the sum over its pairs at that
    replay's tick, read before the next replay records the events again."""
    monkeypatch.setattr(T, "_capturing", lambda: _Graph.capturing)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    model, params = _model()
    state = O.adamw_init(params, OPT)
    step = TS.make_graphed_train_step(model, OPT, RT, microbatches=2)
    for i in range(2):  # eager, then capture + the first replay, untraced
        step(params, state, _train_batch(model, i))
    assert [p[0] for p in step._phases] == ["train.forward", "train.backward"] * 2 + [
        "train.optimizer"]
    assert T.counters() == {}
    T.tracing(True)
    for i in range(2, 5):  # replays 2, 3, 4: a tick of 2, 3, 4 ms
        step(params, state, _train_batch(model, i))
    want = {"train.forward": [4.0, 6.0, 8.0], "train.backward": [4.0, 6.0, 8.0],
            "train.optimizer": [2.0, 3.0, 4.0]}
    for name, ms in want.items():
        recs = T.records(name)
        assert [r.device_ms for r in recs] == ms
        assert all(r.host_ms is None for r in recs)
    assert [r.start_ns for r in T.records("train.forward")] == [
        r.start_ns for r in T.records("train.step")]
    counts = T.counters()
    assert counts["train.step.replay"] == 3 and counts["train.forward"] == 3
    step.release()
    assert step._phases == [] and step._pending == []


def test_a_records_host_start_is_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with T.span("probe"):
                time.sleep(0.002)
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == T.PREFIX + "probe")
    recs = T.records("probe")
    assert len(ranges) == len(recs) == 5
    for r, start in zip(recs, ranges):
        assert abs(r.start_ns - start) < 1_000_000
        assert 2.0 <= r.host_ms


def test_a_spans_range_is_no_user_annotation():
    """A user's range (``record_function``) is copied by the profiler onto
    the device's timeline, where a trace counts it as the device's work;
    a span's range is a function's, on the host alone."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with T.span("probe"):
            torch.ones(3).sum()
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == T.PREFIX + "probe"]
    assert len(ranges) == 1
    assert not ranges[0].is_user_annotation()
    assert ranges[0].device_type() == torch.autograd.DeviceType.CPU


# -- the entry points' [trace] lines ---------------------------------------------------------


def _lines(out, prefix):
    return [line for line in out.splitlines() if line.startswith(prefix)]


def test_launch_serve_cpu_trace_lines(capsys):
    argv = ["--device", "cpu", "--requests", "3", "--batch", "2", "--prompt-len", "6",
            "--gen-len", "4"]
    plain = serve_cli.main(argv)
    out = capsys.readouterr().out
    assert _lines(out, "[trace]") == []
    traced = serve_cli.main(argv + ["--trace"])
    out_t = capsys.readouterr().out
    assert [r for r, _ in plain] == [r for r, _ in traced]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(plain, traced))
    fields = lambda o: _lines(o, "[serve]")[0].split(" tokens in ")[0]  # noqa: E731
    assert fields(out) == fields(out_t) == "[serve] 3 requests, 16"
    assert out_t.index("[serve]") < out_t.index("[trace]")
    got = {m.group(1): m for m in map(LINE.match, _lines(out_t, "[trace]"))}
    waves = 2
    want = {"wave.admit": waves, "wave.prefill": waves, "serve.prefill": waves,
            "wave.decode": waves, "serve.decode": waves * 3, "wave.readback": waves}
    assert {k: int(m.group(2)) for k, m in got.items()} == want
    assert all(m.group(4) == "-" and m.group(5) is None for m in got.values())
    assert not T.tracing(False)  # the switch is off again


def test_launch_train_cpu_trace_lines(capsys):
    argv = ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
            "--layers", "2", "--microbatches", "2"]
    train_cli.main(argv)
    out = capsys.readouterr().out
    train_cli.main(argv + ["--trace"])
    out_t = capsys.readouterr().out
    untimed = lambda o: [re.sub(r"\(\d+ ms\)", "", x) for x in _lines(o, "[train]")]  # noqa: E731
    assert untimed(out) == untimed(out_t) and untimed(out)
    assert _lines(out, "[trace]") == []
    got = {m.group(1): int(m.group(2)) for m in map(LINE.match, _lines(out_t, "[trace]"))}
    assert got == {"train.forward": 3, "train.backward": 3, "train.optimizer": 3}
    assert not T.tracing(False)


# -- on the card -----------------------------------------------------------------------------


def _card_train(card, batch=2, seq=256):
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen))
    state = O.adamw_init(params, OPT)
    step = TS.make_graphed_train_step(model, OPT, train_cli.runtime(True, "none"))
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch))
    batches = [{k: torch.from_numpy(v).to(card) for k, v in data.batch_at(i).items()}
               for i in range(4)]
    return step, params, state, batches


@pytest.mark.card
def test_card_train_phases_sum_to_the_replay(card):
    step, params, state, batches = _card_train(card)
    for b in batches[:2]:  # eager, capture
        step(params, state, b)
    T.tracing(True)
    for b in batches:
        step(params, state, b)
    T.tracing(False)
    whole = [r.device_ms for r in T.records("train.step")]
    parts = [sum(T.records(n)[i].device_ms
                 for n in ("train.forward", "train.backward", "train.optimizer"))
             for i in range(len(whole))]
    assert len(whole) == 4 and all(w > 0 for w in whole)
    for w, p in zip(whole, parts):
        assert abs(p - w) <= 0.02 * w, (parts, whole)
    step.release()


@pytest.mark.card
def test_card_tracing_leaves_the_compiled_steps_outputs_bit_for_bit(card):
    """The same compiled steps, run over the same inputs from the same state
    with tracing off, off again (the control) and on: equal bit for bit."""
    step, params, state, batches = _card_train(card)
    for b in batches[:2]:
        step(params, state, b)
    held = tree_leaves(params) + tree_leaves(state)
    start = [t.clone() for t in held]

    def train(on):
        for t, s in zip(held, start):
            t.copy_(s)
        T.tracing(on)
        losses = [step(params, state, b)[2]["loss"].clone() for b in batches]
        T.tracing(False)
        return losses + [t.clone() for t in tree_leaves(params)]

    runs = [train(False), train(False), train(True)]
    step.release()
    del step, params, state, held, start
    for got in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], got))

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    rt = serve_cli.runtime(True, "bf16")
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen, dtype=rt.dtype()))
    prefill = SS.make_graphed_prefill_step(model, rt)
    decode = SS.make_graphed_decode_step(model, rt)
    cache = split_params(model.init_cache(8, 512 + 16, device=card))[0]
    prompts = torch.randint(0, cfg.vocab_size, (3, 8, 512), generator=gen, device=card,
                            dtype=torch.int64).to(torch.int32)

    def serve(on, waves):
        T.tracing(on)
        out = []
        for w in waves:
            logits, c = prefill(params, {"tokens": prompts[w]}, SS.reset_cache(cache))
            out.append(logits.clone())
            tok = SS.greedy_sample(logits)
            for _ in range(15):
                logits, c = decode(params, tok, c)
                out.append(logits.clone())
                tok = SS.greedy_sample(logits)
            out.append(tok)
        T.tracing(False)
        return out

    serve(False, [0, 1])  # eager, capture
    runs = [serve(False, [1, 2]), serve(True, [1, 2])]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert T.counters()["serve.decode.replay"] == 30


@pytest.mark.card
def test_card_a_capture_in_a_traced_window_is_counted(card):
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg)
    rt = serve_cli.runtime(True, "bf16")
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen, dtype=rt.dtype()))
    cache = split_params(model.init_cache(2, 64, device=card))[0]
    tokens = torch.ones((2, 32), dtype=torch.int32, device=card)
    warm = SS.make_graphed_prefill_step(model, rt)
    for _ in range(3):
        warm(params, {"tokens": tokens}, SS.reset_cache(cache))
    T.tracing(True)
    warm(params, {"tokens": tokens}, SS.reset_cache(cache))
    rebuilt = SS.make_graphed_prefill_step(model, rt)  # another graph of the same step
    for _ in range(3):
        rebuilt(params, {"tokens": tokens}, SS.reset_cache(cache))
    T.tracing(False)
    counts = T.counters()
    assert (counts["serve.prefill.eager"], counts["serve.prefill.capture"],
            counts["serve.prefill.replay"]) == (1, 1, 2)
    assert "[trace] serve.prefill calls 4 " in "\n".join(T.summary())
    warm.release()
    rebuilt.release()
