"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs``: its ``file``) and a traffic mix
(``traffic/<traffic>.json``); a configuration names its plain reference
(``reference/<reference>.py``, by the key ``reference`` in its file); a
metric, end to end or per layer, is read by ``metrics/<name>.py``, whose
``read(rec)`` takes a run's ``cell.Record`` and returns a number or None.
A new cell, configuration, mix or metric is new files and new entries
here, never an edit of a file that exists.

A reference module (the contract ``reference/__init__.py`` states in
full) gives the harness:

* ``FAMILY``: the model family, ``Record.family``;
* ``arch_kwargs(spec)``: the program's config fields, given to the
  program's ``ArchConfig``, or, where the dict holds ``program_config``
  (``"repro_torch.<module>:<name>"``), to that callable of the program
  (``cell.build_program_cfg``);
* optionally ``token_flops(spec, positions)``: the operations of one
  decoded token (``readers.decode_mfu``; without it only the ``dense`` and
  ``ssm`` families have a count);
* ``draw_weights``, ``logits``, ``forward`` and ``decode``: the check's
  float32 arithmetic (``check.served_gap``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Manifest:
    def __init__(self, root: str, bench: dict = None):
        self.root = root
        if bench is None:
            with open(os.path.join(root, "BENCHMARK.json")) as f:
                bench = json.load(f)
        self.bench = bench
        self.here = os.path.join(root, "faasbench")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.here, "traffic", f"{name}.json")) as f:
            return json.load(f)

    @staticmethod
    def reference(spec: dict):
        return importlib.import_module(f"reference.{spec['reference']}")

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"faasbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
