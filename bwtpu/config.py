"""EngineConfig — the single frozen configuration object (SURVEY.md §5.6).

Serialized into the on-disk index artifact so index and engine can never
disagree about block size / sampling rate / conventions.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine + index configuration.

    Index-build parameters (baked into the artifact):
      occ_block:  Occ checkpoint block size in bases. Must stay 128 —
                  the device lattice layout (one 128-base block + its
                  checkpoint row interleaved into one 64 B record,
                  SURVEY.md §7.2) is hard-wired to it.
      sa_rate:    suffix-array text-sampling rate s. Rows r with
                  SA[r] % s == 0 are sampled; a locate LF-walk
                  terminates in <= s steps.

    Search parameters:
      k:          max substitutions for inexact search (reference
                  supports k <= 2).
      max_hits:   per-read hit capacity H in device output arrays
                  (fixed shape; overflow counted + logged, never silent
                  — SURVEY.md §7.4).
      max_cand:   per-read candidate capacity for seed-and-extend
                  verify.

    Batch geometry:
      batch_size: reads per device batch (padded to this).
      read_len:   read length L the batch arrays are padded to.

    Distribution:
      mesh_shape: (n_shard, n_data) device mesh; n_shard == 1 means the
                  index is replicated (bacterial scale), n_shard > 1
                  means interval-sharded (human scale).
    """

    occ_block: int = 128
    sa_rate: int = 32
    k: int = 2
    max_hits: int = 16
    max_cand: int = 32
    batch_size: int = 1024
    read_len: int = 100
    mesh_shape: tuple[int, int] = (1, 1)
    # Compaction capacity factor: locate/verify stages run on at most
    # loc_factor * batch_rows compacted lanes (overflow is counted and
    # logged, never silent). Raise for degenerate many-hit workloads;
    # may be fractional (compacted stages pay their CAP in gather rows
    # — DESIGN.md rows/read roofline).
    loc_factor: float = 2
    # Candidate thinning: a lane with a non-empty interval must take at
    # least min_trips multi-steps before the width-based early stop may
    # fire. Each extra step divides the false-candidate rate by 4^step
    # while true hits always survive, so the locate/verify compaction
    # cap (loc_factor) can shrink several-fold for ~B cheap probe
    # gathers per trip (docs/DESIGN.md "candidate thinning"). 0 = stop
    # as soon as the width fits. Default 1: the round-3 occupancy probe
    # measured min_trips=0 overflowing a loc_factor=1 compaction by
    # ~250 K candidates per 262 K-read batch (k=2: 1.39 M at
    # loc_factor=2), while one guaranteed trip costs ~B cheap probe
    # gathers and leaves 0.45/0.67 occupancy with zero overflow.
    # Results are min_trips-invariant (the verify decides; pinned by
    # tests/test_compact_path.py thinning parity).
    min_trips: int = 1
    # Verified-hit output capacity factor: the one-round-trip hits
    # output (engine._packed_fn hits_output) returns at most
    # max(hit_factor * batch_rows, 4096) hits per shard per batch.
    # The whole buffer crosses device-to-host every batch, so its size
    # is a throughput lever; overflow is counted and logged loudly
    # (hits dropped -> raise hit_factor). ROADMAP queue 1 item 4
    # re-derives the default on the GPU.
    hit_factor: float = 1.0
    # Self-healing overflow (VERDICT r3 item 3; SURVEY.md §7.4 "no
    # silent caps", strengthened to "no lost hits"): when any interval /
    # compaction / hit-buffer capacity overflows, the engine re-runs the
    # batch with every cap doubled (per retry level, so level l runs at
    # 2^l x max_hits / max_cand / loc_factor), up to max_heals retries.
    # Each level compiles one extra program variant on first use; the
    # common no-overflow path is unchanged. If the final level still
    # overflows, the affected reads are MARKED (SAM tag xo:i:1 on the
    # block path) instead of silently truncated.
    heal_overflow: bool = True
    max_heals: int = 3
    # k-mer start table depth d: one lookup replaces the first d chained
    # backward-search steps (docs/DESIGN.md). 0 = disabled; None = auto
    # (chosen from genome size at index build: ~log4(n), capped at 12).
    kmer_d: int | None = None
    # Multi-step Occ lattice step size s: one record gather advances
    # backward search by s bases for both interval bounds (docs/
    # DESIGN.md "multi-step Occ lattice"). 0 disables. 3 (512 B records,
    # index.OCCK_WIDTH[3] = 128 words) measured fastest on the hardware
    # it was tuned on; 4 (2 KB records, 512 words) gathers ~25% fewer
    # rows with wider records. ROADMAP queue 1 item 4 re-derives the
    # choice on the GPU.
    occ_step: int = 3
    # Tiered inexact search (engine.tiered_pipeline_packed): escalated-
    # read capacity as a fraction of the batch. The tier-2 seed
    # expansion runs on at most esc_factor * batch escalated lanes;
    # reads escalated past it are healed / marked like any other
    # capacity. 1.0 = never binds (every read may escalate — adversarial
    # all-mismatch batches stay correct, just tiered-slow); production
    # low-error streams measure ~0.4 escalation at 0.5%/base errors
    # (bench.py k2_lowerr_escalated_frac), so 0.75 trims the tier-2
    # footprint with healing as the backstop.
    esc_factor: float = 1.0

    def __post_init__(self):
        if self.occ_block != 128:
            raise ValueError("occ_block is fixed at 128 by the lattice layout")
        if self.sa_rate < 1:
            raise ValueError("sa_rate must be >= 1")
        if not (0 <= self.k <= 2):
            raise ValueError("k must be in [0, 2]")
        if self.occ_step not in (0, 3, 4):
            raise ValueError("occ_step must be 0 (off), 3 or 4")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(d["mesh_shape"])
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "EngineConfig":
        d = json.loads(s)
        d["mesh_shape"] = tuple(d.get("mesh_shape", (1, 1)))
        if "occ3" in d:  # legacy (format v5) flag
            d["occ_step"] = 3 if d.pop("occ3") else 0
        return cls(**d)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
