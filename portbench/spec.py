"""Everything the harness runs is found by name, from files of its own:

* ``BENCHMARK.json`` at the root: the cells (``workloads``) and metrics;
* ``portbench/cells/<cell>.json``: config, driver, traffic, sample, limits;
* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/drivers/<driver>.py``: what the window runs;
* ``portbench/metrics/<metric>.py``: one reader a per-layer metric;
* ``portbench/reference/<reference>.py``: the plain reference.

A later change adds a cell, a configuration, a driver or a metric by adding
such files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str, root: pathlib.Path = ROOT) -> dict:
    """The ``workloads`` entry of ``name``, with its cell file under ``cell``
    and its configuration file under ``config_file``."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {names})")
    w = dict(found[0])
    w["cell"] = cell(name, root)
    if w["cell"]["config"] != w["config"]:
        raise ValueError(f"{name}: BENCHMARK.json names config {w['config']!r}, "
                         f"its cell file {w['cell']['config']!r}")
    w["config_file"] = config(w["config"], root)
    return w


def cell(name: str, root: pathlib.Path = ROOT) -> dict:
    return _json(root / "portbench" / "cells" / f"{name}.json")


def config(name: str, root: pathlib.Path = ROOT) -> dict:
    return _json(root / "portbench" / "configs" / f"{name}.json")


def _module(kind: str, name: str, root: pathlib.Path):
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(root)} is missing")
    key = f"portbench.{kind}.{name}".replace("-", "_")
    if key in sys.modules and getattr(sys.modules[key], "__file__", None) == str(path):
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: pathlib.Path = ROOT):
    return _module("drivers", name, root)


def metric(name: str, root: pathlib.Path = ROOT):
    """The reader of per-layer metric ``name``: ``read(run) -> float | None``."""
    return _module("metrics", name, root)


def reference(name: str, root: pathlib.Path = ROOT):
    return _module("reference", name, root)


def per_layer(bench: dict, workload_name: str, e2e: list) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    with no list whose end-to-end metric the cell reports."""
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (workload_name in cells) if cells is not None else (m["moves"] in e2e):
            out.append(m)
    return out


def end_to_end(bench: dict, workload_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]


def model_config(conf: dict):
    """The program's ``ModelConfig`` built from the file's ``port`` block
    alone, so that an edit of the program's own config files does not
    change what the cell runs."""
    from repro_torch.configs import base

    port = dict(conf["port"])
    nested = {"rwkv": base.RWKVConfig, "moe": base.MoEConfig, "mla": base.MLAConfig,
              "mamba": base.MambaConfig}
    for key, cls in nested.items():
        if port.get(key) is not None:
            port[key] = cls(**port[key])
    return base.ModelConfig(**port)

