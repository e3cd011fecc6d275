"""The port's static verifier on the torch twins of the JAX world programs
that carry no golden plan, held to the JAX analyzer on the originals.

Each program of ``tests/world_programs/golden_plans/manifest.json`` without
a golden plan (``full_ops.py`` aside) runs through the JAX package's ``check_program`` and its
twin in ``tests/torch_world_programs/`` through the port's, at the
manifest's world size, both in a virtual world (threads, no processes, no
live communication).  The two reports must have the same ``cache_key``,
the same findings as (kind, ranks, severity) and the same schedules with
the sites stripped; the port's sites name its twin's ``file:line``; and
the manifest's finding kinds and ``rewritten`` verdicts hold.  The golden
programs are in ``tests/test_torch_analysis_corpus_golden.py``;
``full_ops.py``, ``ordering.py``'s flip and the three mismatch modes in
``tests/test_torch_analysis_corpus_sweep.py``.
"""

import pytest

from torch_analysis_twins import PLAIN_ENTRIES, check_entry, entry_id


@pytest.mark.parametrize("entry", PLAIN_ENTRIES, ids=entry_id)
def test_twin_matches_jax_analyzer(entry):
    check_entry(entry)
