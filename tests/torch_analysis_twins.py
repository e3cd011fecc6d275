"""Shared by the corpus tests: run a JAX world program and its torch twin
through each package's static verifier and hold the two reports together.

The twins live in ``tests/torch_world_programs/``, the JAX programs and
the manifest of expected verdicts in ``tests/world_programs/`` (read-only
here).  Not a test module: ``tests/test_torch_analysis_corpus*.py`` import
it.
"""

import json
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROGRAMS = os.path.join(REPO, "tests", "world_programs")
PORT_PROGRAMS = os.path.join(REPO, "tests", "torch_world_programs")
GOLDEN = os.path.join(JAX_PROGRAMS, "golden_plans")

with open(os.path.join(GOLDEN, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["programs"]

#: the manifest's entries with a golden plan; full_ops.py alone (the
#: longest JAX run, a file of its own); and the rest
GOLDEN_ENTRIES = [e for e in MANIFEST if e.get("golden")]
FULL_OPS_ENTRIES = [e for e in MANIFEST if e["program"] == "full_ops.py"]
PLAIN_ENTRIES = [e for e in MANIFEST if not e.get("golden")
                 and e["program"] != "full_ops.py"]


def entry_id(entry) -> str:
    return f"{entry['program'][:-3]}-np{entry['np']}"


def analyze_jax(name, np_):
    from mpi4jax_tpu import analysis

    return analysis.check_program(os.path.join(JAX_PROGRAMS, name), np_,
                                  timeout_s=300)


def analyze_port(name, np_):
    from mpi4jax_tpu_torch import analysis

    return analysis.check_program(os.path.join(PORT_PROGRAMS, name), np_,
                                  timeout_s=300, argv=["--device", "cpu"])


_SITE = re.compile(r"^(?P<file>[\w.]+):(?P<line>\d+)(?: `(?P<text>.*)`)?$")


def strip_sites(report):
    """Each rank's schedule with the `` @ site`` of every event dropped."""
    return {r: [s.split(" @ ", 1)[0] for s in evs]
            for r, evs in report.schedules.items()}


def finding_triples(report):
    return sorted((f.kind, tuple(f.ranks), f.severity)
                  for f in report.findings)


def assert_sites_name_twin(name, report):
    """Every event's site is ``<twin file>:<line> `<that line's text>```
    of the port program."""
    with open(os.path.join(PORT_PROGRAMS, name)) as f:
        lines = f.read().splitlines()
    for rank, evs in report.events.items():
        for ev in evs:
            m = _SITE.match(ev.site)
            assert m and m["file"] == name, (rank, ev.site)
            line = lines[int(m["line"]) - 1].strip()
            assert m["text"] == line[:70], (rank, ev.site, line)


def assert_twins(name, jax_report, port_report):
    """The equalities the twins must hold: the cache key, the findings as
    (kind, ranks, severity), and the site-free schedules; the port's sites
    name its own program."""
    assert port_report.cache_key == jax_report.cache_key, \
        port_report.format_table(show_schedules=True)
    assert finding_triples(port_report) == finding_triples(jax_report), \
        (port_report.format_table(), jax_report.format_table())
    assert strip_sites(port_report) == strip_sites(jax_report)
    assert_sites_name_twin(name, port_report)


def check_entry(entry):
    """The twin of a manifest entry against the JAX analyzer and the
    manifest's verdicts."""
    from mpi4jax_tpu_torch import analysis

    name, np_ = entry["program"], entry["np"]
    port = analyze_port(name, np_)
    jax = analyze_jax(name, np_)
    assert_twins(name, jax, port)
    assert sorted(port.kinds()) == sorted(entry["kinds"]), \
        port.format_table()
    if not entry["kinds"]:
        # known-good: the whole program ran, every rank communicated
        assert all(len(v) > 0 for v in port.schedules.values())
    if "rewritten" in entry:
        assert analysis.plan_report(port).rewritten == entry["rewritten"]
