"""Unstacked (list-mode) multi-shard Engine tests.

``vmap_shards=False`` is the human-scale dispatch mode: the stacked
vmapped program relayout-copies the big tables and runs out of device
memory at 10 x 250 Mbp shards (Engine docstring; docs/DESIGN.md
"human-scale index"), so production human-scale runs dispatch
per-shard programs against axis-free shard trees. Round 5 added the
fused-list program on top — ALL per-shard pipelines traced into ONE
jitted function (tuple of shard trees as arguments), so an S-shard
block pays one dispatch + one fetch instead of S round trips.

Neither path had suite coverage before (scale_human_chip.py was the
only caller). Golden parity here pins both, k in {0, 2}, through
dispatch_block/finish_block — the exact path scale_human_chip.py
measures — plus healing through the fused program.
"""

import dataclasses

import pytest

from bwtpu.config import EngineConfig
from bwtpu.engine import Engine
from bwtpu.golden import GoldenFMIndex
from bwtpu.index import build_sharded_index
from bwtpu.readblock import ReadBlock
from bwtpu.results import hit_lists
from bwtpu.simulate import random_genome, simulate_reads


@pytest.fixture(scope="module")
def setup():
    cfg = EngineConfig(sa_rate=4, max_hits=8, max_cand=8, read_len=50,
                       min_trips=1)
    genome = random_genome(9000, seed=21)
    shards, manifest = build_sharded_index(genome, 3, config=cfg,
                                           overlap=64)
    reads, _ = simulate_reads(genome, 24, read_len=50, max_mismatches=2,
                              seed=22)
    return genome, shards, manifest, reads


@pytest.mark.parametrize("fuse", [False, True])
def test_unstacked_block_golden_parity(setup, fuse):
    genome, shards, manifest, reads = setup
    eng = Engine(shards, manifest, vmap_shards=False, fuse_shards=fuse)
    assert isinstance(eng.dev.shard, list) and eng.dev.n_shards == 3
    golden = GoldenFMIndex(genome)
    blk = ReadBlock.from_reads(reads)
    for k in (0, 2):
        handle = eng.dispatch_block(blk, k, pad_to=32)
        assert handle[6] == "hits"
        if fuse:
            # the fused one-dispatch program must actually be what ran
            assert isinstance(handle[4], tuple) and handle[4][0] == "list"
        else:
            assert isinstance(handle[4], list) and len(handle[4]) == 3
        flat = eng.finish_block(handle)
        for r, hs in zip(reads, hit_lists(flat)):
            assert hs == golden.align_read(r.seq, k=k), (fuse, k, r.rid)


def test_unstacked_fused_healing(setup):
    """Binding caps on a repeat-rich genome: the fused program must
    overflow, heal (re-dispatch through the fused path at the doubled
    level), and recover golden-exact hits."""
    genome, _, _, _ = setup
    rep = genome[:120] * 5 + genome[:3000]
    cfg = EngineConfig(sa_rate=4, max_hits=2, max_cand=2, read_len=50,
                       loc_factor=0.5, min_trips=1, max_heals=6)
    shards, manifest = build_sharded_index(rep, 3, config=cfg, overlap=64)
    eng = Engine(shards, manifest, vmap_shards=False, fuse_shards=True)
    golden = GoldenFMIndex(rep)
    reads, _ = simulate_reads(rep, 12, read_len=50, max_mismatches=0,
                              seed=23)
    blk = ReadBlock.from_reads(reads)
    flat = eng.finish_block(eng.dispatch_block(blk, 0, pad_to=16))
    assert eng.stats.heals >= 1, "binding caps were meant to trigger healing"
    for r, hs in zip(reads, hit_lists(flat)):
        assert hs == golden.align_read(r.seq, k=0), ("healed", r.rid)


def test_unstacked_autotune(setup):
    """autotune_caps must work through the fused-list dispatch (the
    occupancy channel rides the fused hit fetch)."""
    genome, shards, manifest, reads = setup
    loose = [dataclasses.replace(s, config=s.config.replace(loc_factor=6))
             for s in shards]
    eng = Engine(loose, manifest, vmap_shards=False, fuse_shards=True)
    golden = GoldenFMIndex(genome)
    blk = ReadBlock.from_reads(reads)
    lf = eng.autotune_caps(blk, 2, pad_to=32)
    assert lf < 6, "autotune must tighten the loose ceiling"
    flat = eng.finish_block(eng.dispatch_block(blk, 2, pad_to=32))
    for r, hs in zip(reads, hit_lists(flat)):
        assert hs == golden.align_read(r.seq, k=2), r.rid


def test_vmap_auto_mode(setup, monkeypatch):
    """Engine(vmap_shards=None) must auto-select list mode when the
    resident tables exceed the stacked-vmap budget — a user aligning a
    human-scale artifact through cli.py (which passes no flag) must
    never hit the stacked relayout OOM."""
    _genome, shards, manifest, _reads = setup
    assert Engine(shards, manifest).vmap_shards  # small: stacked
    monkeypatch.setattr(Engine, "VMAP_STACK_MAX_BYTES", 1)
    eng = Engine(shards, manifest)
    assert not eng.vmap_shards and isinstance(eng.dev.shard, list)
    # explicit flags still win over auto
    assert Engine(shards, manifest, vmap_shards=True).vmap_shards
