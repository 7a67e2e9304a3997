"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each piece
lives in a file of its own under ``portbench/``, found by its name:

- ``configs/<config>.json``: the sizes as they are run; its ``layout``
  key, where it has one, names ``configs/<layout>.py``, the module that
  says how the port lays the configuration out (see ``layout``);
- ``workloads/<cell>.json``: the deployment of one cell (engine, cluster,
  limits, drain, traced span, the check's sample and limit);
- ``traffic/<traffic>.json``: a traffic mix's parameters, read by the
  generator ``traffic/<kind>.py`` that its ``kind`` names;
- ``metrics/<metric>.py``: one metric's reader.

A ``Bench`` searches a list of such directories in order, so a test can put
a throwaway cell, made of data files only, in front of the real ones.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent.parent          # portbench/
ROOT = HERE.parent                                      # the checkout


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Config(dict):
    """A configuration file's contents, and the module its ``layout`` key
    names (None where the file has no such key)."""
    layout_module = None


def layout(cfg: dict):
    """The layout module of a configuration, or None for the dense layout
    that ``serve`` and ``work`` define themselves. A layout module defines
    ``port_arch(cfg)``, ``leaf_shapes(cfg)``, ``attn_layers(cfg)`` and
    ``token_flops(cfg)`` (see the README)."""
    if "layout" not in cfg:
        return None
    mod = getattr(cfg, "layout_module", None)
    if mod is None:
        raise LookupError(f"the configuration names the layout "
                          f"{cfg['layout']!r}: read it with Bench.config, "
                          f"which loads configs/{cfg['layout']}.py")
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Config        # configs/<config>.json
    workload: dict        # workloads/<cell>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]


class Bench:
    def __init__(self, bench: Optional[dict] = None,
                 dirs: Sequence[Path] = (HERE,)):
        self.bench = bench if bench is not None else json.loads(
            (ROOT / "BENCHMARK.json").read_text())
        self.dirs = [Path(d) for d in dirs]
        self._modules: Dict[str, object] = {}

    def find(self, sub: str, name: str, ext: str) -> Path:
        for d in self.dirs:
            p = d / sub / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{ext} under "
                                f"{[str(d) for d in self.dirs]}")

    def data(self, sub: str, name: str) -> dict:
        return json.loads(self.find(sub, name, ".json").read_text())

    def module(self, sub: str, name: str):
        key = f"{sub}/{name}"
        if key not in self._modules:
            path = self.find(sub, name, ".py")
            safe = "pb_" + "".join(c if c.isalnum() else "_" for c in key)
            self._modules[key] = _load_module(path, safe)
        return self._modules[key]

    def config(self, name: str) -> Config:
        """``configs/<name>.json``, with the layout module it names."""
        cfg = Config(self.data("configs", name))
        if "layout" in cfg:
            cfg.layout_module = self.module("configs", cfg["layout"])
        return cfg

    def reader(self, metric: str):
        return self.module("metrics", metric)

    def generator(self, kind: str):
        return self.module("traffic", kind)

    def reference(self, name: str):
        return self.module("configs", name)

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        workload = self.data("workloads", name)
        for key in ("config", "traffic"):
            if workload.get(key) != entry[key]:
                raise ValueError(f"workloads/{name}.json names {key} "
                                 f"{workload.get(key)!r}, BENCHMARK.json "
                                 f"{entry[key]!r}")

        # a metric without a "workloads" key: every cell (end to end), or
        # every cell that reports the metric it moves (per layer)
        e2e = [m for m in self.bench["end_to_end"]
               if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in self.bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
        return Cell(name=name, config_name=entry["config"],
                    traffic_name=entry["traffic"], chips=entry["chips"],
                    config=self.config(entry["config"]),
                    workload=workload,
                    traffic=self.data("traffic", entry["traffic"]),
                    end_to_end=e2e, per_layer=layer)
