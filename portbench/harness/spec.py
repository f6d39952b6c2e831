"""What `BENCHMARK.json` names, found by name on disk.

A cell (`workloads` entry) names a configuration and a traffic mix; a
metric is named in `end_to_end` or `per_layer`.  Each is a file of its
own under the benchmark's folder, found by its name alone:

  configs/<config>.json     the configuration (the `file` of its entry)
  traffic/<traffic>.json    the traffic mix: its `kind` and that kind's
                            knobs, data alone
  kinds/<kind>.py           the code of a kind of traffic: its `Runner`
                            and its `judge` (harness/jobs.py)
  limits/<cell>.json        the limit of every number `correct` compares
  metrics/<metric>.py       the metric's reader: read(run) -> value or
                            None; where that file is missing, the reader
                            of the name up to its last '.' (so that
                            metrics/device_idle_pct.py reads
                            device_idle_pct.rt and device_idle_pct.ccsd)

so a cell, a mix, a kind or a metric is added by adding files and
entries, never by editing a file that exists.  A cell's `chips` are its
cards (`devices`, cuda:0 first, handed to its kind's Runner when there
are more than one); kind 'cc' lays its jobs over a mesh of them
(kinds/cc.py), so a four-card cell is added by files too.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json of the checkout at `root`, and the files it names."""

    def __init__(self, root=ROOT, bench_dir=None):
        self.root = root
        self.bench_dir = bench_dir or os.path.join(root, "portbench")
        self.bench = _load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                       % (name, [w["name"] for w in self.bench["workloads"]]))

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _load_json(os.path.join(self.root, c["file"]))
        raise KeyError("no configuration %r in BENCHMARK.json" % name)

    def traffic(self, name):
        return _load_json(os.path.join(self.bench_dir, "traffic",
                                       name + ".json"))

    def limits(self, cell):
        return _load_json(os.path.join(self.bench_dir, "limits",
                                       cell + ".json"))

    def metrics(self, cell, trace):
        """The entries of the metrics the cell reports: its end-to-end
        metrics untraced, its per-layer metrics traced.  An entry without
        `workloads` belongs to every cell."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", (cell,))]

    def kind(self, name):
        """The module kinds/<name>.py: its Runner and its judge."""
        return _load_module(os.path.join(self.bench_dir, "kinds",
                                         name + ".py"), "kind_" + name)

    def reader(self, metric):
        """The `read` function of metrics/<metric>.py, or of the file of
        the name up to its last '.' where that one is missing."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        if not os.path.exists(path) and "." in metric:
            path = os.path.join(self.bench_dir, "metrics",
                                metric.rsplit(".", 1)[0] + ".py")
        return _load_module(path, "metric_" + metric).read


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
