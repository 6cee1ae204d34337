"""Files of the benchmark that a name in a traffic mix or a configuration
finds:

* ``features/<key>.py``  a pod feature: a template key beyond the requests,
  priority and labels (``spread``, ...).  It adds itself to the program's
  pod object (``to_pod``) and brings the reference's part of it (``Ref``:
  its state per node or domain, what it makes wrong, where a pod may still
  go, which nodes it keeps open to a pod in every round);
* ``scores/<Plugin>.py`` a score plugin the reference scores with, named
  as the configuration's ``reference_scores`` name it.

Plain Python: a plugin imports nothing of the program (``to_pod`` is
handed the program's API module).  A new feature or score plugin is a new
file; no file here changes.
"""

from __future__ import annotations

import importlib.util
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str, prefix: str):
    """The module of a benchmark file, loaded by its path."""
    if not os.path.exists(path):
        raise KeyError("no file %s" % path)
    name = prefix + re.sub(r"[^A-Za-z0-9_]", "_",
                           os.path.splitext(os.path.basename(path))[0])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Plugins:
    """The feature and score files under one benchmark directory."""

    def __init__(self, bench_dir: str = HERE):
        self.dir = bench_dir
        self._cache = {}

    def _get(self, kind: str, name: str):
        key = (kind, name)
        if key not in self._cache:
            self._cache[key] = load_module(
                os.path.join(self.dir, kind, name + ".py"),
                "kbench_%s_" % kind)
        return self._cache[key]

    def feature(self, name: str):
        return self._get("features", name)

    def score(self, name: str):
        return self._get("scores", name)
