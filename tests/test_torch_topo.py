"""The port's topology, knobs and simulators against the JAX package's.

``mpi4jax_tpu_torch/utils/config.py`` (the knobs of the hierarchical
allreduce), ``mpi4jax_tpu_torch/topo`` (``parse_fake_hosts``,
``Topology``, the simulators) and ``topo/_ici_leg.eligible`` are held to
``mpi4jax_tpu/utils/config.py``, ``mpi4jax_tpu/topo`` and
``mpi4jax_tpu/topo/_ici_leg.py`` on the same inputs: the same values and
the same errors, and the simulators bit for bit.  A port fingerprint
counts cards (``cards``) where a JAX one counts TPU chips (``tpu_chips``).
"""

import numpy as np
import pytest

from mpi4jax_tpu import topo as jtopo
from mpi4jax_tpu.topo import _ici_leg as jleg
from mpi4jax_tpu.utils import config as jconfig
from mpi4jax_tpu_torch import topo
from mpi4jax_tpu_torch.topo import _ici_leg as leg
from mpi4jax_tpu_torch.utils import config

KNOBS = {
    "MPI4JAX_TPU_COLL_QUANT": ("quant_mode",
                               ["allow", "deny", "force", " force\n", "",
                                "on", "Force"]),
    "MPI4JAX_TPU_TOPO": ("topo_mode", ["auto", "off", " off ", "", "maybe"]),
    "MPI4JAX_TPU_HIER": ("hier_mode",
                         ["allow", "deny", "force", "", "sometimes"]),
    "MPI4JAX_TPU_ICI_LEG": ("ici_leg_mode",
                            ["auto", "off", "force", "\tforce", "", "on"]),
    "MPI4JAX_TPU_FAKE_HOSTS": ("fake_hosts_spec",
                               ["r0|r1", "r0,r1|r2,r3", "", "  "]),
}


def _outcome(fn):
    try:
        return ("value", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("env", sorted(KNOBS))
def test_knob_parsers_match_jax(env, monkeypatch):
    name, values = KNOBS[env]
    monkeypatch.delenv(env, raising=False)
    assert getattr(config, name)() == getattr(jconfig, name)()
    for v in values:
        monkeypatch.setenv(env, v)
        got = _outcome(getattr(config, name))
        assert got == _outcome(getattr(jconfig, name)), (env, v)
    # test_topo.py's cases: a typo raises and names the knob
    if env != "MPI4JAX_TPU_FAKE_HOSTS":
        monkeypatch.setenv(env, values[-1])
        with pytest.raises(ValueError, match=env):
            getattr(config, name)()


SPECS = [("r0,r1|r2,r3", 4), ("0 , 1 | 2", 3), ("r0|r2", 4),
         ("r0,r1|r2", 2), ("", 4), (None, 4), ("r0,banana", 4),
         ("r0|r0", 4), ("R0,r1|r2,r3,r4,r5", 6), ("r0,r2|r1,r3", 4),
         ("r-1", 2), ("r0,r9|r1", 2)]


@pytest.mark.parametrize("spec,size", SPECS)
def test_parse_fake_hosts_matches_jax(spec, size):
    got = _outcome(lambda: topo.parse_fake_hosts(spec, size))
    assert got == _outcome(lambda: jtopo.parse_fake_hosts(spec, size))


def _fps(hosts, chips):
    """(port fingerprints, JAX fingerprints) of the same ranks."""
    port, ref = [], []
    for host, c in zip(hosts, chips):
        fake = host if host.startswith("fake") else None
        base = {"v": 1, "host": host, "boot_id": "b", "fake": fake}
        port.append(dict(base, cards=c))
        ref.append(dict(base, tpu_chips=c))
    return port, ref


LAYOUTS = [
    (["a", "a", "b", "b", "a"], [0] * 5),
    (["same"] * 3, [0, 0, 0]),
    (["fake-host-0", "fake-host-0", "fake-host-1"], [0, 0, 0]),
    (["a", "a", "b", "b"], [4, 4, 0, 0]),
    (["a", "b", "a", "b"], [1, 1, 1, 1]),
    (["x"] * 4, [4] * 4),
]


@pytest.mark.parametrize("hosts,chips", LAYOUTS)
def test_topology_matches_jax(hosts, chips):
    port, ref = _fps(hosts, chips)
    t, j = topo.build_topology(port), jtopo.build_topology(ref)
    assert t.islands == j.islands
    assert t.island_of == j.island_of
    assert t.leaders == j.leaders
    assert t.tiers == j.tiers
    assert (t.multi, t.n_islands) == (j.multi, j.n_islands)
    n = len(hosts)
    for r in range(n):
        assert t.island(r) == j.island(r) and t.leader(r) == j.leader(r)
        for s in range(n):
            assert t.link(r, s) == j.link(r, s), (r, s)


def test_fingerprint_counts_cards_only_on_a_cuda_device(monkeypatch):
    import torch

    monkeypatch.setattr(topo, "_card_count", lambda: 2)
    monkeypatch.setenv("MPI4JAX_TPU_FAKE_HOSTS", "r0|r1")
    on_card = topo.local_fingerprint(1, 2, torch.device("cuda", 0))
    assert on_card["cards"] == 2 and on_card["fake"] == "fake-host-1"
    assert topo.local_fingerprint(1, 2, torch.device("cpu"))["cards"] == 0
    assert topo.local_fingerprint(0, 2)["cards"] == 0


def test_eligibility_matches_jax(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_HIER", raising=False)
    monkeypatch.delenv("MPI4JAX_TPU_PLAN", raising=False)
    shapes = {
        "ici": (["a", "a", "b", "b"], [4] * 4),
        "shm": (["a", "a", "b", "b"], [0] * 4),
        "flat": (["a"] * 4, [4] * 4),
        "half": (["a", "a", "b", "b"], [4, 4, 0, 0]),
        "singletons": (["a", "b", "c"], [0, 0, 0]),
    }
    for deny in (False, True):
        if deny:
            monkeypatch.setenv("MPI4JAX_TPU_HIER", "deny")
        for name, (hosts, chips) in shapes.items():
            port, ref = _fps(hosts, chips)
            t, j = topo.build_topology(port), jtopo.build_topology(ref)
            for mode in ("auto", "off", "force"):
                assert leg.eligible(t, mode=mode) == jleg.eligible(
                    j, mode=mode), (name, mode, deny)
    assert not leg.eligible(None, mode="force")
    assert not jleg.eligible(None, mode="force")
    # test_topo.py:346-370's expectations
    monkeypatch.delenv("MPI4JAX_TPU_HIER", raising=False)
    t_ici = topo.build_topology(_fps(*shapes["ici"])[0])
    t_shm = topo.build_topology(_fps(*shapes["shm"])[0])
    assert leg.eligible(t_ici, mode="auto")
    assert not leg.eligible(t_shm, mode="auto")
    assert leg.eligible(t_shm, mode="force")
    assert not leg.eligible(t_ici, mode="off")
    st = leg.ici_leg_status()
    assert st["active"] is False and st["mode"] == "auto"


WORLDS = {"2x2": (4, "r0,r1|r2,r3"), "4+2": (6, "r0,r1,r2,r3|r4,r5"),
          "interleaved": (4, "r0,r2|r1,r3")}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("count", [3, 513, 70000])
def test_simulators_match_jax_bit_for_bit(world, count):
    size, spec = WORLDS[world]
    labels = topo.parse_fake_hosts(spec, size)
    islands = topo.build_topology(
        [{"v": 1, "host": "h", "boot_id": "", "fake": lab} for lab in labels]
    ).islands
    rng = np.random.RandomState(count + size)
    parts = list(rng.randn(size, count).astype(np.float32) * 2)

    def same(a, b):
        return a.dtype == b.dtype == np.float32 and np.array_equal(
            a.view(np.uint32), b.view(np.uint32))

    assert same(topo.simulate_ring_sum(parts), jtopo.simulate_ring_sum(parts))
    assert same(topo.simulate_rd_sum(parts), jtopo.simulate_rd_sum(parts))
    for intra in ("member", "ring"):
        assert same(topo.simulate_hring_sum(parts, islands, intra),
                    jtopo.simulate_hring_sum(parts, islands, intra))
        assert same(topo.simulate_htree_sum(parts, islands, intra),
                    jtopo.simulate_htree_sum(parts, islands, intra))
    assert same(topo.simulate_ici_q_sum(parts, islands),
                jtopo.simulate_ici_q_sum(parts, islands))
    with pytest.raises(ValueError):
        topo.simulate_hring_sum(parts, islands, intra="banana")
