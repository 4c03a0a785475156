"""The compiled prefill, train step and measured step on the CPU, where no
CUDA graph can be captured.

* Each refuses CPU tensors with no eager fallback, and its binding
  refuses another cache, parameter set, optimizer state or shape.
* ``CountedGraph`` keeps the launch counters over a real prefill region
  and a real train region, against a stand-in graph.
* The capture's errors: an out-of-memory error keeps its type, any other
  carries the step's name, and the region's error wins over one raised
  while the capture ends.
* The capture protocol (first call eager, then capture, then replays over
  static inputs and outputs) runs end to end against an emulated graph
  that replays by running the captured region again: the compiled prefill
  equals the eager one, and k compiled train steps equal k donated and k
  functional steps leaf for leaf, the learning rate included (the donated
  AdamW update advances its step count in place).
* ``WallClockEvaluator`` on CPU tensors measures the eager step as before;
  on the card it times replays of a ``GraphedStep`` and releases it.
* A trainer that rebuilds its step after a failure releases the old
  graph before the new one is captured, and a train step's capture first
  frees what the eager step left.
* ``launch/train.py --device cpu`` and ``launch/serve.py --device cpu``
  give the eager paths' answers.

Bit-for-bit equality of the graphed and the eager steps is checked on the
card (``chip_smoke.py``, phases ``graphs``, ``families``, ``train`` and
``sweep``).
"""
import contextlib
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.kernels import ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.models.params import split_params, tree_leaves, tree_map
from repro_torch.models.runtime import Runtime
from repro_torch.optim import optimizer as O
from repro_torch.runtime import graphs as G
from repro_torch.serve import serve_step as SS
from repro_torch.train import train_step as TS
from repro_torch.tuning import evaluator as E

B, S, CACHE_LEN = 2, 6, 12
RT = Runtime(compute_dtype="f32")
OPT = O.OptimizerConfig(learning_rate=1e-2, warmup_steps=3, total_steps=8)


def _model(arch):
    model = build_model(get_config(arch).reduced())
    params, _ = split_params(model.init(torch.Generator().manual_seed(0)))
    return model, params


def _cache(model, batch=B, cache_len=CACHE_LEN):
    return split_params(model.init_cache(batch, cache_len))[0]


def _batch(model, batch=B, seq=S, seed=0):
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))
                                      .astype(np.int32))}
    out.update(serve_cli.frontend_inputs(cfg, batch, "cpu"))
    return out


def _train_batch(model, step, batch=4, seq=8):
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=seq,
                                      global_batch=batch))
    return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# -- no CPU path, no fallback --------------------------------------------------------


def test_graphed_prefill_refuses_cpu_tensors_without_falling_back(monkeypatch):
    model, params = _model("qwen2-0.5b")
    cache = _cache(model)
    before = [t.clone() for t in tree_leaves(cache["layers"])]
    monkeypatch.setattr(Model, "apply", lambda *a, **kw: pytest.fail("fell back to eager"))
    step = SS.make_graphed_prefill_step(model, RT)
    with pytest.raises(RuntimeError, match="on the card"):
        step(params, _batch(model), cache)
    assert step.binding is None and step.graph is None
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(cache["layers"])))


def test_graphed_train_step_refuses_cpu_tensors_without_falling_back(monkeypatch):
    model, params = _model("qwen2-0.5b")
    state = O.adamw_init(params, OPT)
    before = [t.clone() for t in tree_leaves(params) + tree_leaves(state)]
    monkeypatch.setattr(Model, "apply", lambda *a, **kw: pytest.fail("fell back to eager"))
    step = TS.make_graphed_train_step(model, OPT, RT)
    with pytest.raises(RuntimeError, match="on the card"):
        step(params, state, _train_batch(model, 0))
    assert step.binding is None and step.graph is None
    after = tree_leaves(params) + tree_leaves(state)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_measured_step_refuses_cpu_tensors():
    calls = []
    step = G.GraphedStep("rmsnorm", "measured step")
    run = lambda inputs=None: calls.append(1)  # noqa: E731
    with pytest.raises(RuntimeError, match="on the card"):
        step.run({"arguments": (torch.ones(3),)}, {}, run, run)
    assert calls == [] and step.binding is None and step.graph is None


def test_trainer_builds_the_graphed_step_only_on_the_card(monkeypatch):
    """On the CPU the trainer's step is the donated eager step; on the card
    it is the graphed one."""
    from repro_torch.train import trainer as T

    built = []
    monkeypatch.setattr(T, "make_graphed_train_step", lambda *a, **kw: built.append("graphed"))
    monkeypatch.setattr(T, "make_train_step",
                        lambda *a, **kw: built.append(("eager", kw.get("donate"))))
    cfg = get_config("qwen2-0.5b").reduced()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    T.Trainer(cfg, OPT, data, T.TrainerConfig(steps=1, device="cpu"))
    assert built == [("eager", True)]
    trainer = object.__new__(T.Trainer)
    built.clear()
    trainer.__dict__.update(model=None, opt_cfg=OPT, rt=RT, device=torch.device("cuda"),
                            tcfg=T.TrainerConfig(device="cuda"))
    trainer._build_step()
    assert built == ["graphed"]


# -- bindings ------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base", "internvl2-26b"])
def test_prefill_binding_refuses_another_cache_shape_or_parameter_set(arch):
    model, params = _model(arch)
    cache, batch = _cache(model), _batch(model)

    def check(p, b, c):
        bound.check({"cache": c["layers"], "parameter set": p}, {"batch": b})

    bound = G.Binding(arch, "prefill step", {"cache": cache["layers"], "parameter set": params},
                      {"batch": batch})
    check(params, batch, cache)
    check(params, _batch(model, seed=1), dict(cache, pos=3))  # new values, same storage
    with pytest.raises(ValueError, match="another cache"):
        check(params, batch, _cache(model))
    with pytest.raises(ValueError, match="shapes"):
        check(params, batch, _cache(model, cache_len=CACHE_LEN + 1))
    with pytest.raises(ValueError, match="shapes"):
        check(params, _batch(model, seq=S + 1), cache)
    with pytest.raises(ValueError, match="shapes"):
        check(params, _batch(model, batch=B + 1), _cache(model, B + 1))
    with pytest.raises(ValueError, match="parameter set"):
        check(_clone(params), batch, cache)
    for key in set(batch) - {"tokens"}:  # a frontend's embeddings are copied in too
        other = dict(batch, **{key: batch[key][:, :-1]})
        with pytest.raises(ValueError, match="shapes"):
            check(params, other, cache)


def test_train_binding_refuses_another_parameter_set_state_or_shape():
    model, params = _model("qwen2-0.5b")
    state = O.adamw_init(params, OPT)
    batch = _train_batch(model, 0)

    def held(p, s):
        return {"parameter set": p, "optimizer state": s}

    bound = G.Binding("qwen2", "train step", held(params, state), {"batch": batch})
    bound.check(held(params, dict(state)), {"batch": _train_batch(model, 1)})
    with pytest.raises(ValueError, match="another parameter set"):
        bound.check(held(_clone(params), state), {"batch": batch})
    with pytest.raises(ValueError, match="another optimizer state"):
        bound.check(held(params, _clone(state)), {"batch": batch})
    with pytest.raises(ValueError, match="another optimizer state"):  # a restored count
        bound.check(held(params, dict(state, count=state["count"].clone())), {"batch": batch})
    with pytest.raises(ValueError, match="shapes"):
        bound.check(held(params, state), {"batch": _train_batch(model, 0, batch=2)})
    with pytest.raises(ValueError, match="shapes"):
        bound.check(held(params, state), {"batch": _train_batch(model, 0, seq=9)})
    bf16 = O.adamw_init(params, O.OptimizerConfig(state_dtype="bf16"))
    with pytest.raises(ValueError, match="shapes"):
        bound.check(held(params, bf16), {"batch": batch})


def test_measured_binding_refuses_other_arguments():
    x, scale = torch.ones(4, 8), torch.ones(8)
    bound = G.Binding("rmsnorm", "measured step", {"arguments": (x, scale)}, {})
    bound.check({"arguments": (x, scale)}, {})
    with pytest.raises(ValueError, match="another arguments"):
        bound.check({"arguments": (x.clone(), scale)}, {})
    with pytest.raises(ValueError, match="shapes"):
        bound.check({"arguments": (x[:2], scale)}, {})


def test_require_card_names_the_step_and_the_devices():
    with pytest.raises(RuntimeError, match=r"^dense_lm: a compiled measured step .* lie on cpu"):
        G.require_card("dense_lm", "measured step", ({"w": torch.ones(2)}, [torch.ones(1)]))
    assert G.tensors(({"a": torch.ones(1), "b": [torch.ones(2), 3]}, None)) != []


# -- CountedGraph over real regions --------------------------------------------------------


class _Counter:
    def __init__(self, n=0):
        self.launches = n


class _StandInGraph:
    """Captures by running the region on the CPU; a replay runs no Python
    that a counter would see."""

    def __init__(self, fail_on_exit=None):
        self.replays, self.fail_on_exit = 0, fail_on_exit

    @contextlib.contextmanager
    def capture(self):
        try:
            yield
        finally:
            if self.fail_on_exit is not None:
                raise self.fail_on_exit

    def replay(self):
        self.replays += 1


@pytest.fixture
def counted_rmsnorm(monkeypatch):
    """A counter that the RMSNorm oracle adds one to at each call (a stand-in
    for a kernel wrapper's launch count on the card)."""
    counter = _Counter(3)
    norm = ref.rmsnorm_ref

    def counted(*a, **kw):
        counter.launches += 1
        return norm(*a, **kw)

    monkeypatch.setattr(ref, "rmsnorm_ref", counted)
    return counter


def test_counted_graph_over_a_prefill_region(counted_rmsnorm):
    model, params = _model("qwen2-0.5b")
    layers = model.cfg.num_layers
    cache, batch = _cache(model), _batch(model)
    graph = G.CountedGraph(_StandInGraph(), [counted_rmsnorm, _Counter(5)])
    logits, new = graph.capture(lambda: SS.make_prefill_step(model, RT)(params, batch, cache))
    assert logits.shape == (B, 1, model.cfg.padded_vocab) and new["pos"] == S
    assert [c.launches for c in graph.counters] == [3, 5]  # the capture launched nothing
    assert graph.increase == [2 * layers + 1, 0]
    for _ in range(3):
        graph.replay()
    assert [c.launches for c in graph.counters] == [3 + 3 * (2 * layers + 1), 5]


def test_counted_graph_over_a_train_region(counted_rmsnorm):
    model, params = _model("qwen2-0.5b")
    layers = model.cfg.num_layers
    state = O.adamw_init(params, OPT)
    step = TS.make_train_step(model, OPT, RT, microbatches=2, donate=True)
    graph = G.CountedGraph(_StandInGraph(), [counted_rmsnorm])
    metrics = graph.capture(lambda: step(params, state, _train_batch(model, 0))[2])
    assert math.isfinite(float(metrics["loss"])) and int(state["count"]) == 1
    # two microbatches, each one forward; the oracle backward reruns no forward
    assert graph.increase == [2 * (2 * layers + 1)] and counted_rmsnorm.launches == 3
    graph.replay()
    assert counted_rmsnorm.launches == 3 + 2 * (2 * layers + 1)


# -- the capture's errors -------------------------------------------------------------------


def _raise(e):
    def region():
        raise e
    return region


def test_an_out_of_memory_error_in_the_capture_keeps_its_type():
    counter = _Counter(1)
    graph = G.CountedGraph(_StandInGraph(), [counter])
    with pytest.raises(torch.OutOfMemoryError, match="Tried to allocate"):
        G.capture(graph, _raise(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")),
                  "dense_lm", "measured step")
    assert counter.launches == 1 and graph.increase is None


def test_the_regions_error_wins_over_one_raised_as_the_capture_ends():
    oom = torch.OutOfMemoryError("CUDA out of memory")
    graph = G.CountedGraph(_StandInGraph(fail_on_exit=RuntimeError("Invalid capture.")), [])
    with pytest.raises(torch.OutOfMemoryError) as info:
        G.capture(graph, _raise(oom), "dense_lm", "measured step")
    assert info.value is oom and "Invalid capture" in str(info.value.__cause__)


def test_a_failed_capture_raises_with_the_steps_name():
    graph = G.CountedGraph(_StandInGraph(), [])
    err = RuntimeError("operation not permitted when stream is capturing")
    with pytest.raises(RuntimeError, match="^qwen2-0.5b: the prefill step could not be "
                                           "captured into a CUDA graph: operation not"):
        G.capture(graph, _raise(err), "qwen2-0.5b", "prefill step")
    with pytest.raises(RuntimeError, match="^gla_scan: the measured step could not"):
        G.capture(G.CountedGraph(_StandInGraph(fail_on_exit=RuntimeError("Invalid capture.")),
                                 []), lambda: 1, "gla_scan", "measured step")


# -- the protocol end to end, against an emulated graph -------------------------------------


class _Emulated:
    """``StepGraph`` on the CPU: ``eager`` runs the step; ``capture`` runs
    the region once with the ``held`` tensors put back after it (a capture
    computes nothing) and keeps it; ``replay`` runs it again and writes its
    outputs into the captured ones, as a graph replays into its static
    outputs.  ``events`` records captures and releases, in order."""

    held = []
    events = []
    made = []

    def __init__(self, name, what, device):
        self.name, self.what = name, what
        self.graph = None
        self.eagers = self.replays = 0
        self.released = False
        self.made.append(self)

    def eager(self, fn):
        self.eagers += 1
        return fn()

    def capture(self, region):
        saved = [t.clone() for t in self.held]
        out = region()
        for t, s in zip(self.held, saved):
            t.copy_(s)
        self.region, self.out, self.graph = region, out, "captured"
        self.events.append(("capture", self))
        return out

    def replay(self):
        self.replays += 1
        for dst, src in zip(G.tensors(self.out), G.tensors(self.region())):
            dst.copy_(src)

    def release(self):
        self.graph, self.released = None, True
        self.events.append(("release", self))


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(G, "require_card", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(G, "StepGraph", _Emulated)
    _Emulated.events, _Emulated.made = [], []
    yield _Emulated
    _Emulated.held = []


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base", "rwkv6-3b"])
def test_the_compiled_prefill_protocol_answers_as_the_eager_prefill(arch, emulated):
    model, params = _model(arch)
    cache = _cache(model)
    emulated.held = tree_leaves(cache["layers"])
    step = SS.make_graphed_prefill_step(model, RT)
    eager = SS.make_prefill_step(model, RT)
    outs = []
    for wave in range(3):  # eager, captured + replayed, replayed
        batch = _batch(model, seed=wave)
        want_logits, want = eager(params, batch, _cache(model))
        logits, got = step(params, batch, SS.reset_cache(cache))
        assert got["layers"] is cache["layers"] and got["pos"] == want["pos"] == S
        assert torch.equal(logits, want_logits)
        for a, b in zip(tree_leaves(got["layers"]), tree_leaves(want["layers"])):
            assert torch.equal(a, b)
        outs.append(logits)
    assert step.steps.eagers == 1 and step.steps.replays == 2
    assert outs[1] is outs[2]  # the graph's static output
    with pytest.raises(ValueError, match="another cache"):
        step(params, _batch(model), _cache(model))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base", "rwkv6-3b"])
def test_the_compiled_decode_protocol_answers_as_the_eager_decode(arch, emulated):
    """Two waves of prefill + 4 decode steps over one cache: the compiled
    decode (eager, captured, replayed; its device position set after each
    prefill and advanced by the graph) gives the eager decode's logits and
    cache at every step."""
    model, params = _model(arch)
    cache = _cache(model)
    prefill = SS.make_prefill_step(model, RT)
    eager = SS.make_decode_step(model, RT)
    step = SS.make_graphed_decode_step(model, RT)
    for wave in range(2):
        batch = _batch(model, seed=wave)
        _, want = prefill(params, batch, _cache(model))
        logits, got = prefill(params, batch, SS.reset_cache(cache))
        tok = SS.greedy_sample(logits)
        for i in range(4):
            want_logits, want = eager(params, tok, want)
            logits, got = step(params, tok, got)
            if wave == 0 and i == 0:  # the graph holds its position: restored after a capture
                emulated.held = tree_leaves(cache["layers"]) + [step._pos]
            assert got["pos"] == want["pos"] == S + i + 1
            assert torch.equal(logits, want_logits)
            for a, b in zip(tree_leaves(got["layers"]), tree_leaves(want["layers"])):
                assert torch.equal(a, b)
            tok = SS.greedy_sample(logits)
    assert step.steps.eagers == 1 and step.steps.replays == 7
    assert int(step._pos) == S + 4


def test_compiled_train_steps_equal_donated_and_functional_steps(emulated):
    """Four steps each way from the same weights and batches: params, m, v,
    the step count and every metric, the learning rate included, equal
    leaf for leaf; the bound count keeps its storage and advances by one
    a step."""
    model, params = _model("qwen2-0.5b")
    steps = 4
    fparams, fstate = _clone(params), O.adamw_init(params, OPT)
    dparams, dstate = _clone(params), O.adamw_init(params, OPT)
    gparams, gstate = _clone(params), O.adamw_init(params, OPT)
    emulated.held = tree_leaves(gparams) + tree_leaves(gstate)
    functional = TS.make_train_step(model, OPT, RT)
    donated = TS.make_train_step(model, OPT, RT, donate=True)
    graphed = TS.make_graphed_train_step(model, OPT, RT)
    count = gstate["count"]
    lrs = []
    for i in range(steps):
        batch = _train_batch(model, i)
        fparams, fstate, fm = functional(fparams, fstate, batch)
        dparams, dstate, dm = donated(dparams, dstate, batch)
        gparams, gstate, gm = graphed(gparams, gstate, batch)
        assert gstate["count"] is count and int(count) == i + 1
        for m in (dm, gm):
            assert sorted(m) == sorted(fm)
            assert all(torch.equal(m[k], fm[k]) for k in fm)
        lrs.append(float(gm["lr"]))
    assert lrs == [float(O.lr_schedule(OPT, torch.tensor(i + 1))) for i in range(steps)]
    assert len(set(lrs)) == steps  # the schedule moved at every replay
    assert graphed.steps.eagers == 1 and graphed.steps.replays == steps - 1
    for tree in (dparams, gparams):
        for a, b in zip(tree_leaves(tree), tree_leaves(fparams)):
            assert torch.equal(a, b)
    for st in (dstate, gstate):
        for a, b in zip(tree_leaves(st), tree_leaves(fstate)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="another optimizer state"):
        graphed(gparams, O.adamw_init(gparams, OPT), _train_batch(model, 0))


def test_the_donated_update_advances_the_count_in_place():
    params = {"w": torch.ones(8, 8), "b": torch.zeros(8)}
    state = O.adamw_init(params, OPT)
    count = state["count"]
    grads = {"w": torch.full((8, 8), 0.5), "b": torch.ones(8)}
    for i in range(3):
        _, new, metrics = O.adamw_update(grads, state, params, OPT, donate=True)
        assert new["count"] is count and count.data_ptr() == state["count"].data_ptr()
        assert int(count) == i + 1
        assert torch.equal(metrics["lr"], O.lr_schedule(OPT, torch.tensor(i + 1)))
    _, new, _ = O.adamw_update(grads, state, params, OPT)  # functional: a new count
    assert new["count"] is not count and int(count) == 3 and int(new["count"]) == 4


# -- the measured step ---------------------------------------------------------------------


def _counting_step():
    calls = []

    def step(x, scale):
        calls.append(1)
        return ref.rmsnorm_ref(x, scale, 1e-6)

    return step, calls


def test_wall_clock_on_cpu_measures_the_eager_step(monkeypatch):
    monkeypatch.setattr(G, "GraphedStep", lambda *a, **kw: pytest.fail("captured on the CPU"))
    x, scale = torch.ones(16, 8), torch.ones(8)
    step, calls = _counting_step()
    ev = E.WallClockEvaluator(lambda p: (step, (x, scale), 16.0), warmup=2, iters=3,
                              adaptive=False, name="rmsnorm")
    value, meta = ev({})
    assert len(calls) == 2 + 3 and value > 0
    assert sorted(meta) == ["build_seconds", "ci_rel_halfwidth", "cost_seconds",
                            "iters", "step_seconds"]
    assert meta["iters"] == 3 and value == pytest.approx(16.0 / meta["step_seconds"])


@pytest.fixture
def on_card(emulated, monkeypatch):
    """The evaluator sees its arguments on the card; the graph is emulated."""
    monkeypatch.setattr(E, "_cuda_devices", lambda obj, out: {"cuda:0"})
    monkeypatch.setattr(E, "_wait", lambda out, args: None)
    return emulated


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_wall_clock_on_the_card_times_replays_and_releases_the_graph(on_card, adaptive,
                                                                    warmup):
    """``warmup`` eager calls (at least one), the capture and one replay in
    the build, then only replays timed; the graph released at the end."""
    x, scale = torch.ones(16, 8), torch.ones(8)
    step, calls = _counting_step()
    ev = E.WallClockEvaluator(lambda p: (step, (x, scale), 16.0), warmup=warmup, iters=3,
                              adaptive=adaptive, name="rmsnorm")
    value, meta = ev({})
    (graph,) = on_card.made
    assert graph.name == "rmsnorm" and graph.what == "measured step" and graph.released
    assert graph.eagers == max(1, warmup)
    assert graph.replays == meta["iters"] + 1 and value > 0
    # the eager calls, the capture's run of the region and a run a replay
    assert len(calls) == graph.eagers + 1 + graph.replays
    assert sorted(meta) == ["build_seconds", "ci_rel_halfwidth", "cost_seconds", "iters",
                            "step_seconds"]


def test_wall_clock_binds_the_graph_once_a_point(on_card, monkeypatch):
    """The binding is made and checked in the build; the timed replays walk
    no argument."""
    checks = []
    check = G.Binding.check
    monkeypatch.setattr(G.Binding, "check", lambda *a: checks.append(1) or check(*a))
    x, scale = torch.ones(16, 8), torch.ones(8)
    step, _ = _counting_step()
    _, meta = E.WallClockEvaluator(lambda p: (step, (x, scale), 16.0), warmup=2, iters=4,
                                   adaptive=False, name="rmsnorm")({})
    assert meta["iters"] == 4 and len(checks) == 2  # the build's calls after the first


def test_wall_clock_releases_the_graph_when_the_measurement_fails(on_card, monkeypatch):
    def boom(out, args):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(E, "_wait", boom)
    ev = E.WallClockEvaluator(lambda p: (lambda x: x * 2, (torch.ones(2),), 1.0), name="k")
    with pytest.raises(torch.OutOfMemoryError):
        ev({})
    assert on_card.made[0].released


def test_wall_clock_releases_the_graph_when_the_capture_fails(on_card, monkeypatch):
    """An out-of-memory error in the capture reaches the caller with its
    type (a measured workload scores it ``-inf``), and the graph's pool is
    released."""
    def capture(self, region):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(_Emulated, "capture", capture)
    ev = E.WallClockEvaluator(lambda p: (lambda x: x * 2, (torch.ones(2),), 1.0),
                              name="dense_lm")
    with pytest.raises(torch.OutOfMemoryError):
        ev({})
    (graph,) = on_card.made
    assert graph.eagers == 1 and graph.released


# -- memory: what a capture frees first, and a rebuilt step ---------------------------------


def test_a_train_capture_first_frees_what_the_eager_step_left(emulated, monkeypatch):
    """The compiled train step collects garbage and empties the allocator's
    cache once, just before the call that captures: tensors that
    autograd's reference cycles hold from the eager step would stay
    allocated beside the pool."""
    events = []
    monkeypatch.setattr(TS.gc, "collect", lambda: events.append("collect"))
    monkeypatch.setattr(TS.torch.cuda, "empty_cache", lambda: events.append("empty_cache"))
    capture = _Emulated.capture
    monkeypatch.setattr(_Emulated, "capture",
                        lambda self, region: events.append("capture") or capture(self, region))
    model, params = _model("qwen2-0.5b")
    state = O.adamw_init(params, OPT)
    emulated.held = tree_leaves(params) + tree_leaves(state)
    step = TS.make_graphed_train_step(model, OPT, RT)
    for i in range(3):  # eager, captured + replayed, replayed
        step(params, state, _train_batch(model, i))
    assert events == ["collect", "empty_cache", "capture"]


def test_a_rebuilt_train_step_releases_the_old_graph_first(monkeypatch):
    from repro_torch.train import trainer as T

    events = []

    class Step:
        def __init__(self, n):
            self.n = n
            events.append(("built", n))

        def release(self):
            events.append(("released", self.n))

    made = iter(range(3))
    monkeypatch.setattr(T, "make_graphed_train_step", lambda *a, **kw: Step(next(made)))
    trainer = object.__new__(T.Trainer)
    trainer.__dict__.update(model=None, opt_cfg=OPT, rt=RT, device=torch.device("cuda"),
                            tcfg=T.TrainerConfig(device="cuda"))
    for _ in range(3):
        trainer._build_step()
    assert events == [("built", 0), ("released", 0), ("built", 1), ("released", 1),
                      ("built", 2)]


def test_resume_releases_the_failed_steps_graph_before_capturing_again(emulated, monkeypatch,
                                                                       tmp_path):
    """A failure and resume through the graphed step (emulated): the first
    step's graph is released before the rebuilt step captures, and the run
    answers as one without a failure."""
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.train import trainer as T

    def graphed(*a, microbatches=1, tuning_db=None, donate=True):
        step = TS.make_graphed_train_step(*a, microbatches=microbatches, tuning_db=tuning_db)

        def call(params, state, batch):
            _Emulated.held = tree_leaves(params) + tree_leaves(state)
            return step(params, state, batch)

        call.release = step.release
        return call

    monkeypatch.setattr(T, "make_train_step", graphed)
    cfg = get_config("qwen2-0.5b").reduced()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)

    def run(**kw):
        tcfg = T.TrainerConfig(steps=5, log_every=0, device="cpu", **kw)
        trainer = T.Trainer(cfg, OPT, data, tcfg,
                            failure_injector=FailureInjector(at_steps=[3]) if kw else None)
        return trainer, trainer.run()

    _, plain = run()
    _Emulated.events, _Emulated.made = [], []
    trainer, log = run(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    first, second = _Emulated.made
    assert _Emulated.events == [("capture", first), ("release", first), ("capture", second)]
    assert "restored step 2" in trainer.events
    assert [m["step"] for m in log] == [0, 1, 2, 2, 3, 4]
    want = {m["step"]: m["loss"] for m in plain}
    assert all(m["loss"] == want[m["step"]] for m in log)


# -- the entry points on the CPU -------------------------------------------------------------


def test_launch_train_cpu_answers_as_the_functional_step(monkeypatch):
    """``launch/train.py --device cpu`` (the donated eager step) against the
    functional step from the same weights and batches: losses, learning
    rates and final params equal."""
    argv = ["--device", "cpu", "--reduced", "--steps", "4", "--batch", "4", "--seq", "16",
            "--layers", "2"]
    args = train_cli.parse_args(argv)
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    made = []

    class Kept(train_cli.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(train_cli, "Trainer", Kept)
    log = train_cli.main(argv)
    (trainer,) = made
    assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ  # the allocator is the card's
    cfg = train_cli.model_config(args)
    model = build_model(cfg)
    params, _ = split_params(model.init(torch.Generator().manual_seed(0)))
    opt = O.OptimizerConfig(learning_rate=args.lr, warmup_steps=20, total_steps=args.steps)
    state = O.adamw_init(params, opt)
    step = TS.make_train_step(model, opt, train_cli.runtime(False, "none"))
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))
    for i, m in enumerate(log):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        params, state, want = step(params, state, batch)
        assert m["loss"] == float(want["loss"]) and m["lr"] == float(want["lr"])
    assert int(trainer.opt_state["count"]) == len(log) == 4
    for a, b in zip(tree_leaves(trainer.params), tree_leaves(params)):
        assert torch.equal(a, b)


def test_the_card_allocator_takes_expandable_segments_unless_the_caller_chose(monkeypatch):
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    train_cli.card_allocator()
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:128")
    train_cli.card_allocator()
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "max_split_size_mb:128"


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_serve_cpu_answers_as_an_eager_prefill_and_decode(arch, capsys):
    """The frontend families through ``launch/serve.py --device cpu``: each
    request's tokens those of an eager prefill + decode on a fresh cache."""
    requests, batch, prompt_len, gen_len = 3, 2, 6, 3
    done = dict(serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", str(requests),
                                "--batch", str(batch), "--prompt-len", str(prompt_len),
                                "--gen-len", str(gen_len)]))
    assert f"[serve] {requests} requests" in capsys.readouterr().out
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    rt = serve_cli.runtime(False, "f32")
    params, _ = split_params(model.init(torch.Generator().manual_seed(0), dtype=rt.dtype()))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(prompt_len // 2, prompt_len + 1))
               for _ in range(requests)]
    for w in range(0, requests, batch):
        toks = np.zeros((batch, prompt_len), np.int32)
        for i, p in enumerate(prompts[w: w + batch]):
            toks[i, prompt_len - len(p):] = p
        inputs = {"tokens": torch.from_numpy(toks),
                  **serve_cli.frontend_inputs(cfg, batch, "cpu")}
        want, _ = SS.generate(model, params, inputs, rt=rt,
                              cache=_cache(model, batch, prompt_len + gen_len), steps=gen_len)
        for i in range(len(prompts[w: w + batch])):
            np.testing.assert_array_equal(done[w + i], want[i].numpy())
