"""Nothing of the benchmark loads JAX or the JAX package (top-level
module names compared whole: lilliput_tpu_torch begins with
lilliput_tpu), and the reference loads nothing of the program."""

import glob
import json
import os
import subprocess
import sys

from conftest import PKG, REPO

LOAD_ALL = r"""
import glob, importlib, importlib.util, json, os, sys
pkg = sys.argv[1]
sys.path.insert(0, os.path.dirname(pkg))
spec = importlib.util.spec_from_file_location("portbench_run",
                                              os.path.join(pkg, "run.py"))
importlib.util.module_from_spec(spec)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
for sub in ("inputs", "reference", "entries"):
    for f in sorted(glob.glob(os.path.join(pkg, sub, "*.py"))):
        name = os.path.basename(f)[:-3]
        if name != "__init__":
            importlib.import_module(f"portbench.{sub}.{name}")
for mod in ("harness", "trace", "native", "control"):
    importlib.import_module("portbench." + mod)
for f in sorted(glob.glob(os.path.join(pkg, "metrics", "*.py"))
                + glob.glob(os.path.join(pkg, "roofline", "*.py"))):
    s = importlib.util.spec_from_file_location("m" + str(abs(hash(f))), f)
    s.loader.exec_module(importlib.util.module_from_spec(s))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = r"""
import glob, importlib, json, os, sys
pkg = sys.argv[1]
sys.path.insert(0, os.path.dirname(pkg))
for f in sorted(glob.glob(os.path.join(pkg, "reference", "*.py"))):
    importlib.import_module("portbench.reference." + os.path.basename(f)[:-3])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code, PKG],
                         capture_output=True, text=True, check=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=""))
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_benchmark_loads_no_jax():
    names = _top_level(LOAD_ALL)
    assert "portbench" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "lilliput_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "lilliput_tpu",
                        "lilliput_tpu_torch"}


def test_sources_name_no_jax_import():
    for f in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        with open(f) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0].rstrip(",")
                    assert top not in ("jax", "jaxlib", "flax",
                                       "lilliput_tpu"), (f, line)
