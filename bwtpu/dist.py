"""Distributed alignment: ('shard', 'data') mesh + ring rotation.

Device-mesh re-design of the reference's master/worker distribution
(components C16-C18, SURVEY.md §2.3-2.4, §3.5, §7.5):

- The FM-index is interval-sharded: device (s, d) holds shard s's
  lattices (replicated along 'data'). Bacterial-scale genomes use
  n_shard == 1 (pure replication).
- Read batches are sharded over BOTH mesh axes — every device starts
  with its own slice — and ride a `lax.ppermute` ring around the
  'shard' axis, carrying their accumulating hit buffers with them
  (the ring-attention schedule applied to index shards instead of KV
  blocks, SURVEY.md §5.7). After S hops every read has met every
  shard and its hits have come home with it: neighbour-to-neighbour
  traffic only, no gather at a master. (The ring was chosen for a
  nearest-neighbour torus; GPUs joined all to all by NVLink serve it
  as well — ROADMAP queue 1 item 6 compares it with replication.)
- Hits are tagged by the hit-buffer slot == shard id; the host resolves
  global int64 positions as shard_offset[slot] + local_pos (device
  arithmetic stays int32, SURVEY.md §7.2).

Multi-host: each host runs this same program under
`jax.distributed.initialize()`; 'data' spans hosts (each host ingests
its own read stream over the network), 'shard' is laid out within hosts
so ring hops stay on the intra-host links.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bwtpu.engine import (DeviceIndexSet, _shard_occ_step, assemble_hits,
                          compact_cap, encode_batch, exact_pipeline,
                          exact_pipeline_packed, inexact_pipeline,
                          inexact_pipeline_packed, pack_reads_for_bench,
                          pick_kmer_depth, upload_index)
from bwtpu.golden import Hit
from bwtpu.index import FMIndex, ShardManifest
from bwtpu.kernels.verify2 import NM_INVALID

log = logging.getLogger(__name__)


def make_mesh(n_shard: int, n_data: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_shard * n_data
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev_array = np.array(devices[:need]).reshape(n_shard, n_data)
    return Mesh(dev_array, ("shard", "data"))


def make_multihost_mesh(n_shard: int) -> Mesh:
    """('shard', 'data') mesh for a multi-process run, laid out so that

    - each host owns an (n_shard, d_local) sub-grid: the 'shard' ring
      (ppermute hops) stays WITHIN a host — never over the network;
    - hosts occupy contiguous, process-ordered columns of 'data', so a
      batch sharded P(('data','shard')) assigns every host a contiguous
      block of rows == the reads that host ingested (SURVEY.md §3.5
      data-parallel ingestion; no cross-host read shuffling).
    """
    H = jax.process_count()
    cols = []
    for h in range(H):
        devs_h = [d for d in jax.devices() if d.process_index == h]
        if len(devs_h) % n_shard:
            raise ValueError(
                f"host {h} has {len(devs_h)} devices, not divisible by "
                f"{n_shard} shards"
            )
        d_local = len(devs_h) // n_shard
        cols.append(np.array(devs_h).reshape(n_shard, d_local))
    return Mesh(np.concatenate(cols, axis=1), ("shard", "data"))


def build_ring_align(
    mesh: Mesh,
    *,
    k: int,
    d: int,
    max_hits: int,
    max_cand: int,
    sa_rate: int,
    loc_factor: int = 2,
    debug_checks: bool = False,
    cap_scale: int = 1,
):
    """Compile the ring-rotation align step over the mesh.

    exact (k==0): fn(shard_tree, ra_codes, ra_amb, lens) ->
        (pos [B2, S, H], valid, overflow [B2, S], loc_over [S])
    inexact:      fn(shard_tree, seed..., packed reads..., lens) ->
        (cand [B2, S, Ct], nm, valid, overflow [B2, S], loc/ver over)
    Slot s of axis 1 holds hits against shard s.
    """
    S = mesh.shape["shard"]
    perm = [(i, (i + 1) % S) for i in range(S)]

    def rotate(xs):
        return tuple(jax.lax.ppermute(x, "shard", perm) for x in xs)

    if k == 0:

        def fn(shard, ra_codes, ra_amb, lens):
            shard = jax.tree.map(lambda x: x[0], shard)
            my_shard = jax.lax.axis_index("shard")
            b = ra_codes.shape[0]
            if debug_checks:
                # divergence detector (SURVEY.md §5.2): every device must
                # run the same program over same-shaped batches; a psum
                # of a shape checksum flags a desynchronized participant
                # before it deadlocks a collective.
                csum = jnp.int32(b * 1000003 + ra_codes.shape[1])
                total = jax.lax.psum(csum, ("shard", "data"))
                n_dev = mesh.shape["shard"] * mesh.shape["data"]
                chk = jnp.where(total == csum * n_dev, 0, 1)
                ra_codes = ra_codes + chk * 0  # keep the check live
            hp = jnp.zeros((b, S, max_hits), jnp.int32)
            hv = jnp.zeros((b, S, max_hits), jnp.bool_)
            ov = jnp.zeros((b, S), jnp.int32)
            lo = jnp.zeros((1, S), jnp.int32)

            def body(_, carry):
                ra_codes, ra_amb, lens, hp, hv, ov, lo = carry
                pos, valid, overflow, loc_over = exact_pipeline(
                    shard, ra_codes, ra_amb, lens,
                    d=d, max_hits=max_hits, sa_rate=sa_rate,
                    loc_factor=loc_factor, cap_scale=cap_scale,
                )
                upd = jax.lax.dynamic_update_index_in_dim
                hp = upd(hp, pos, my_shard, 1)
                hv = upd(hv, valid, my_shard, 1)
                ov = upd(ov, overflow, my_shard, 1)
                lo = upd(lo, loc_over[None], my_shard, 1)
                return rotate((ra_codes, ra_amb, lens, hp, hv, ov, lo))

            ra_codes, ra_amb, lens, hp, hv, ov, lo = jax.lax.fori_loop(
                0, S, body, (ra_codes, ra_amb, lens, hp, hv, ov, lo)
            )
            return hp, hv, ov, lo

        batch2 = P(("data", "shard"), None)
        in_specs = (P("shard"), batch2, batch2, P(("data", "shard")))
        out_specs = (
            P(("data", "shard"), None, None),
            P(("data", "shard"), None, None),
            P(("data", "shard"), None),
            P(("data", "shard"), None),
        )
    else:
        Ct = (k + 1) * max_cand

        def fn(shard, s_ra, s_amb, s_lens, s_off, rw, ab, lm, lens):
            shard = jax.tree.map(lambda x: x[0], shard)
            my_shard = jax.lax.axis_index("shard")
            b = rw.shape[0]
            hc = jnp.zeros((b, S, Ct), jnp.int32)
            hn = jnp.full((b, S, Ct), NM_INVALID, jnp.int32)
            hv = jnp.zeros((b, S, Ct), jnp.bool_)
            ov = jnp.zeros((b, S), jnp.int32)
            lo = jnp.zeros((1, S, 2), jnp.int32)

            def body(_, carry):
                s_ra, s_amb, s_lens, s_off, rw, ab, lm, lens, hc, hn, hv, ov, lo = carry
                cand, nm, valid, overflow, loc_over, ver_over = inexact_pipeline(
                    shard, s_ra, s_amb, s_lens, s_off, rw, ab, lm, lens,
                    k=k, d=d, max_loc=max_cand, sa_rate=sa_rate,
                    loc_factor=loc_factor, cap_scale=cap_scale,
                )
                upd = jax.lax.dynamic_update_index_in_dim
                hc = upd(hc, cand, my_shard, 1)
                hn = upd(hn, nm, my_shard, 1)
                hv = upd(hv, valid, my_shard, 1)
                ov = upd(ov, overflow, my_shard, 1)
                lo = upd(lo, jnp.stack([loc_over, ver_over])[None], my_shard, 1)
                return rotate(
                    (s_ra, s_amb, s_lens, s_off, rw, ab, lm, lens, hc, hn, hv, ov, lo)
                )

            out = jax.lax.fori_loop(
                0, S, body,
                (s_ra, s_amb, s_lens, s_off, rw, ab, lm, lens, hc, hn, hv, ov, lo),
            )
            hc, hn, hv, ov, lo = out[8:]
            return hc, hn, hv, ov, lo

        batch2 = P(("data", "shard"), None)
        b1 = P(("data", "shard"))
        in_specs = (
            P("shard"),
            batch2, batch2, b1, b1,  # seeds (rows = B2 * nS)
            batch2, batch2, batch2, b1,  # packed reads + lens
        )
        out_specs = (
            P(("data", "shard"), None, None),
            P(("data", "shard"), None, None),
            P(("data", "shard"), None, None),
            P(("data", "shard"), None),
            P(("data", "shard"), None, None),
        )

    mapped = jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    return jax.jit(mapped)


def build_ring_align_packed(
    mesh: Mesh,
    *,
    k: int,
    d: int,
    L: int,
    max_hits: int,
    max_cand: int,
    sa_rate: int,
    loc_factor: int = 2,
    cap_scale: int = 1,
    wide_steps: int = 0,
):
    """Packed-uniform ring align: only 2-bit packed forward reads rotate
    around the 'shard' ring (16x less link traffic than int32 code
    arrays); each hop derives strands/seeds on device and runs the
    3-step packed pipelines. Local output rows are [fwd_loc | rev_loc]
    per device — the host reorders (DistEngine._deinterleave).

    exact: fn(shard_tree, read_words, amb_bits) ->
        (pos [2B, S, H], valid, overflow [2B, S], loc_over [S])
    inexact adds nm and a second overflow scalar, like build_ring_align.
    """
    S = mesh.shape["shard"]
    perm = [(i, (i + 1) % S) for i in range(S)]

    def rotate(xs):
        return tuple(jax.lax.ppermute(x, "shard", perm) for x in xs)

    if k == 0:

        def fn(shard, rw, ab):
            shard = jax.tree.map(lambda x: x[0], shard)
            my_shard = jax.lax.axis_index("shard")
            b2 = 2 * rw.shape[0]
            hp = jnp.zeros((b2, S, max_hits), jnp.int32)
            hv = jnp.zeros((b2, S, max_hits), jnp.bool_)
            ov = jnp.zeros((b2, S), jnp.int32)
            lo = jnp.zeros((1, S), jnp.int32)

            def body(_, carry):
                rw, ab, hp, hv, ov, lo = carry
                pos, valid, overflow, loc_over = exact_pipeline_packed(
                    shard, rw, ab, L=L, d=d, max_hits=max_hits,
                    sa_rate=sa_rate, loc_factor=loc_factor,
                    cap_scale=cap_scale, wide_steps=wide_steps,
                )
                upd = jax.lax.dynamic_update_index_in_dim
                hp = upd(hp, pos, my_shard, 1)
                hv = upd(hv, valid, my_shard, 1)
                ov = upd(ov, overflow, my_shard, 1)
                lo = upd(lo, loc_over[None], my_shard, 1)
                return rotate((rw, ab, hp, hv, ov, lo))

            rw, ab, hp, hv, ov, lo = jax.lax.fori_loop(
                0, S, body, (rw, ab, hp, hv, ov, lo)
            )
            return hp, hv, ov, lo

        n_out = 4
    else:
        Ct = (k + 1) * max_cand

        def fn(shard, rw, ab):
            shard = jax.tree.map(lambda x: x[0], shard)
            my_shard = jax.lax.axis_index("shard")
            b2 = 2 * rw.shape[0]
            hc = jnp.zeros((b2, S, Ct), jnp.int32)
            hn = jnp.full((b2, S, Ct), NM_INVALID, jnp.int32)
            hv = jnp.zeros((b2, S, Ct), jnp.bool_)
            ov = jnp.zeros((b2, S), jnp.int32)
            lo = jnp.zeros((1, S, 2), jnp.int32)

            def body(_, carry):
                rw, ab, hc, hn, hv, ov, lo = carry
                cand, nm, valid, overflow, loc_over, ver_over = (
                    inexact_pipeline_packed(
                        shard, rw, ab, L=L, k=k, d=d, max_loc=max_cand,
                        sa_rate=sa_rate, loc_factor=loc_factor,
                        cap_scale=cap_scale,
                        wide_steps=wide_steps,
                    )
                )
                upd = jax.lax.dynamic_update_index_in_dim
                hc = upd(hc, cand, my_shard, 1)
                hn = upd(hn, nm, my_shard, 1)
                hv = upd(hv, valid, my_shard, 1)
                ov = upd(ov, overflow, my_shard, 1)
                lo = upd(lo, jnp.stack([loc_over, ver_over])[None], my_shard, 1)
                return rotate((rw, ab, hc, hn, hv, ov, lo))

            out = jax.lax.fori_loop(0, S, body, (rw, ab, hc, hn, hv, ov, lo))
            return out[2:]

        n_out = 5

    batch2 = P(("data", "shard"), None)
    in_specs = (P("shard"), batch2, batch2)
    out_specs = tuple(
        P(("data", "shard"), *([None] * extra))
        for extra in ([2, 2, 1, 1] if n_out == 4 else [2, 2, 2, 1, 2])
    )
    mapped = jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    return jax.jit(mapped)


def build_ring_align_compact(
    mesh: Mesh,
    *,
    k: int,
    d: int,
    L: int,
    max_hits: int,
    max_cand: int,
    sa_rate: int,
    loc_factor: float = 2,
    min_trips: int = 0,
    cap_scale: int = 1,
    wide_steps: int = 0,
):
    """Flagship ring: packed reads rotate, COMPACTED hits come home in
    one final all-to-all (VERDICT r2 missing #2 / next #2).

    The round-2 ring ran the dense scatter-back pipelines and rotated
    full (b2, S, Ct) hit buffers on EVERY hop — link traffic grew as
    S^2 and the on-device scatter rode along.
    This builder instead:

      - runs the compact_output pipelines (the single-chip flagship
        path: no dense scatter-back) against the visiting batch;
      - keeps each hop's fixed-cap compacted hit list (cand, nm, sel,
        count) HOME, indexed by hop;
      - after S hops reorders hop -> origin (origin of hop h is
        (my_shard - h) mod S) and runs ONE lax.all_to_all over 'shard',
        so every hit crosses the ring exactly once.

    Per-device per-batch link bytes: S hops x packed reads (2 x b x W
    int32) riding + one crossing of S x cap x 12 B hits — linear in S,
    vs the dense ring's S x b2 x Ct x 9 B x S hops.

    Outputs (host decodes in DistEngine._finish_packed_compact), all
    with out_spec P(('data','shard'), ...) — axis 0 is device-major
    (data major, shard minor), one S-sized block of source-shard rows
    per device:
      hc   int32[n_dev*S, cap]  candidate start positions
      hn   int32[n_dev*S, cap]  mismatch counts
      hsel int32[n_dev*S, cap]  flat local candidate slots (lane*Ct+j)
      hcnt int32[n_dev*S]       live entries per (device, source shard)
      hov  int32[n_dev*S, b2]   per-row interval overflow counts
      hco  int32[n_dev*S]       compaction overflow totals
    """
    S = mesh.shape["shard"]
    perm = [(i, (i + 1) % S) for i in range(S)]

    def rotate(xs):
        return tuple(jax.lax.ppermute(x, "shard", perm) for x in xs)

    def fn(shard, rw, ab):
        shard = jax.tree.map(lambda x: x[0], shard)
        my = jax.lax.axis_index("shard")
        b2 = 2 * rw.shape[0]
        cap = compact_cap(b2, loc_factor, cap_scale)
        Hc = jnp.zeros((S, cap), jnp.int32)
        Hn = jnp.full((S, cap), NM_INVALID, jnp.int32)
        Hs = jnp.zeros((S, cap), jnp.int32)
        Hcnt = jnp.zeros((S,), jnp.int32)
        Hov = jnp.zeros((S, b2), jnp.int32)
        Hco = jnp.zeros((S,), jnp.int32)

        def body(h, carry):
            rw, ab, Hc, Hn, Hs, Hcnt, Hov, Hco = carry
            if k == 0:
                cand_c, nm_c, sel, count, overflow, co = exact_pipeline_packed(
                    shard, rw, ab, L=L, d=d, max_hits=max_hits,
                    sa_rate=sa_rate, loc_factor=loc_factor,
                    min_trips=min_trips, compact_output=True,
                    cap_scale=cap_scale,
                    wide_steps=wide_steps,
                )
            else:
                cand_c, nm_c, sel, count, overflow, co = (
                    inexact_pipeline_packed(
                        shard, rw, ab, L=L, k=k, d=d, max_loc=max_cand,
                        sa_rate=sa_rate, loc_factor=loc_factor,
                        min_trips=min_trips, compact_output=True,
                        cap_scale=cap_scale,
                        wide_steps=wide_steps,
                    )
                )
            upd = jax.lax.dynamic_update_index_in_dim
            Hc = upd(Hc, cand_c, h, 0)
            Hn = upd(Hn, nm_c, h, 0)
            Hs = upd(Hs, sel, h, 0)
            Hcnt = upd(Hcnt, count[None], h, 0)
            Hov = upd(Hov, overflow, h, 0)
            Hco = upd(Hco, co[None], h, 0)
            rw, ab = rotate((rw, ab))
            return rw, ab, Hc, Hn, Hs, Hcnt, Hov, Hco

        out = jax.lax.fori_loop(0, S, body, (rw, ab, Hc, Hn, Hs, Hcnt, Hov, Hco))
        Hc, Hn, Hs, Hcnt, Hov, Hco = out[2:]
        # hop -> origin (the batch visiting at hop h started at shard
        # (my - h) mod S), then one all-to-all sends block o to device o
        ordr = (my - jnp.arange(S, dtype=jnp.int32)) % S
        a2a = lambda x: jax.lax.all_to_all(
            jnp.take(x, ordr, axis=0), "shard", split_axis=0, concat_axis=0
        )
        return tuple(a2a(x) for x in (Hc, Hn, Hs, Hcnt, Hov, Hco))

    batch2 = P(("data", "shard"), None)
    in_specs = (P("shard"), batch2, batch2)
    dev0 = P(("data", "shard"))
    out_specs = (
        P(("data", "shard"), None), P(("data", "shard"), None),
        P(("data", "shard"), None), dev0,
        P(("data", "shard"), None), dev0,
    )
    mapped = jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    return jax.jit(mapped)


class DistEngine:
    """Alignment engine over a ('shard', 'data') device mesh."""

    def __init__(
        self,
        shards: list[FMIndex],
        manifest: ShardManifest,
        n_data: int = 1,
        devices=None,
        debug_checks: bool = False,
    ):
        self.shards = shards
        self.manifest = manifest
        self.config = shards[0].config
        S = len(shards)
        self.multiprocess = jax.process_count() > 1
        if self.multiprocess:
            self.mesh = make_multihost_mesh(S)
        else:
            self.mesh = make_mesh(S, n_data, devices)

        def sharding_fn(extra_dims):
            return NamedSharding(self.mesh, P("shard", *([None] * extra_dims)))

        self.dev = upload_index(shards, sharding_fn=sharding_fn)
        self.kmer_depths = sorted(shards[0].kmer_tables)
        self.debug_checks = debug_checks
        self._compiled: dict = {}
        # per-read truncation flags for THIS HOST's reads from the most
        # recent finish_batch, set only when the final heal level still
        # overflowed (ADVICE r4: the dist path used to log-only where
        # the single-chip block path marks xo:i:1) — consumers
        # (bwtpu.multihost) read it right after finish_batch
        self.last_truncated: np.ndarray | None = None
        self.heals = 0  # self-healing ring re-dispatches (doubled caps)

    @property
    def n_lanes(self) -> int:
        """LOCAL batch rows must be a multiple of this (every process
        dispatches its own chunk; chunks stack host-contiguously)."""
        S = self.mesh.shape["shard"]
        if self.multiprocess:
            return S * (self.mesh.shape["data"] // jax.process_count())
        return S * self.mesh.shape["data"]

    def _put_batch(self, x: np.ndarray):
        """Local batch rows -> device array sharded P(('data','shard')).
        Multi-process: the local array is this host's contiguous block
        of the global batch (make_multihost_mesh layout)."""
        spec = P(("data", "shard")) if x.ndim == 1 else P(("data", "shard"), None)
        if self.multiprocess:
            from jax.experimental import multihost_utils

            return multihost_utils.host_local_array_to_global_array(
                np.asarray(x), self.mesh, spec
            )
        return jax.device_put(np.asarray(x), NamedSharding(self.mesh, spec))

    def _get_local(self, x):
        """Device output -> this host's block as NumPy (axis 0 is the
        device-major P(('data','shard')) layout in both cases)."""
        if self.multiprocess:
            from jax.experimental import multihost_utils

            spec = P(("data", "shard"), *([None] * (x.ndim - 1)))
            x = multihost_utils.global_array_to_host_local_array(
                x, self.mesh, spec
            )
        return np.asarray(x)

    def _wide_steps(self, d: int) -> int:
        """Same rule as engine.Engine._wide_steps (wide start-table
        intervals must be narrowed with two-gather 1-step trips before
        the multi-step loop — human-scale shards)."""
        if d <= 0:
            return 0
        lam = max(sh.n for sh in self.shards) / 4.0 ** d
        w = 0
        # target E[width] <= 8: at ~15 (2.5 Gbp, d=12) the FIRST
        # multi-step trip still straggles ~6% of lanes (interval spans
        # the 256-row window with P ~ width/256) — more than the B/64
        # finisher, so every batch healed; <= 8 leaves ~2x headroom
        while lam > 8 and w < 8:
            lam /= 4
            w += 1
        return w

    def _caps(self, k: int, level: int):
        """Escalated capacities for self-healing overflow (same rule as
        engine.Engine._caps: every cap doubles per heal level)."""
        f = 1 << level
        cfg = self.config
        mh = cfg.max_hits * f
        mc = cfg.max_cand * f
        max_loc = mc if k else mh
        lf = min(cfg.loc_factor * f, (k + 1) * max_loc)
        return mh, mc, lf

    def _get_fn(self, k: int, d: int, level: int = 0):
        mh, mc, lf = self._caps(k, level)
        key = (k, d, level)
        if key not in self._compiled:
            self._compiled[key] = build_ring_align(
                self.mesh, k=k, d=d,
                max_hits=mh, max_cand=mc,
                sa_rate=self.config.sa_rate,
                loc_factor=lf, debug_checks=self.debug_checks,
                cap_scale=1 << level,
            )
        return self._compiled[key]

    def _get_packed_fn(self, k: int, d: int, L: int, level: int = 0):
        mh, mc, lf = self._caps(k, level)
        key = ("packed", k, d, L, level)
        if key not in self._compiled:
            self._compiled[key] = build_ring_align_packed(
                self.mesh, k=k, d=d, L=L,
                max_hits=mh, max_cand=mc,
                sa_rate=self.config.sa_rate,
                loc_factor=lf, cap_scale=1 << level,
                wide_steps=self._wide_steps(d),
            )
        return self._compiled[key]

    def _get_compact_fn(self, k: int, d: int, L: int, level: int = 0):
        mh, mc, lf = self._caps(k, level)
        key = ("compact", k, d, L, level)
        if key not in self._compiled:
            self._compiled[key] = build_ring_align_compact(
                self.mesh, k=k, d=d, L=L,
                max_hits=mh, max_cand=mc,
                sa_rate=self.config.sa_rate,
                loc_factor=lf,
                min_trips=self.config.min_trips, cap_scale=1 << level,
                wide_steps=self._wide_steps(d),
            )
        return self._compiled[key]

    def _deinterleave(self, x: np.ndarray, B2: int) -> np.ndarray:
        """Packed-ring outputs order rows [fwd_loc | rev_loc] per device;
        reorder to the global [all fwd | all rev] layout assemble_hits
        expects."""
        n_dev = self.n_lanes
        b_loc = B2 // (2 * n_dev)
        return (
            x.reshape((n_dev, 2, b_loc) + x.shape[1:])
            .swapaxes(0, 1)
            .reshape((B2,) + x.shape[1:])
        )

    def _dispatch_packed(self, reads, k: int, L: int, level: int = 0):
        lanes = self.n_lanes
        B = len(reads)
        Bp = max(lanes, -(-B // lanes) * lanes)
        from bwtpu import dna
        from bwtpu.kernels.verify2 import pack_reads

        codes = np.zeros((Bp, L), dtype=np.int32)
        amb = np.ones((Bp, L), dtype=np.int32)  # pad rows all-ambiguous
        c, m = dna.encode_with_mask("".join(r.seq for r in reads))
        codes[:B] = c.reshape(B, L)
        amb[:B] = m.reshape(B, L)
        rw, ab, _ = pack_reads(codes, amb, np.full(Bp, L, np.int32))

        put2 = self._put_batch
        if k == 0:
            d = pick_kmer_depth(self.kmer_depths, L)
        else:
            d = pick_kmer_depth(self.kmer_depths, L // (k + 1))
        if _shard_occ_step(self.dev.shard) and d >= 1:
            # flagship: compact pipelines in the ring, hits cross once
            fn = self._get_compact_fn(k, d, L, level)
            out = fn(self.dev.shard, put2(rw), put2(ab))
            return ("packed_compact", reads, Bp, k, out, level)
        fn = self._get_packed_fn(k, d, L, level)
        out = fn(self.dev.shard, put2(rw), put2(ab))
        return ("packed", reads, Bp, k, out, level)

    def _finish_packed(self, handle):
        _, reads, Bp, k, out, level = handle
        out = jax.block_until_ready(out)
        B2 = 2 * Bp
        if k == 0:
            pos, valid, overflow, comp_over = out
            nm = None
        else:
            pos, nm, valid, overflow, comp_over = out
            nm = self._deinterleave(self._get_local(nm), B2).transpose(1, 0, 2)
        co = int(self._get_local(comp_over).sum())
        ov = self._get_local(overflow)  # (B2_local, S) per-row counts
        n_over = int((ov.sum(axis=-1) > 0).sum())
        # per-read truncation: deinterleave to [all fwd | all rev] and
        # OR the two strand rows of each read
        ovd = self._deinterleave(ov, B2).sum(axis=-1)
        trunc = ((ovd[:Bp] + ovd[Bp:]) > 0)[: len(reads)]
        pos = self._deinterleave(self._get_local(pos), B2).transpose(1, 0, 2)
        valid = self._deinterleave(self._get_local(valid), B2).transpose(1, 0, 2)
        hits = assemble_hits(
            reads, Bp, pos, nm, valid,
            [sh.text_len for sh in self.shards],
            [sh.shard_offset for sh in self.shards],
        )
        return hits, n_over, co, trunc

    def _finish_packed_compact(self, handle):
        """Decode the compact ring's homed hit blocks.

        Axis 0 of every output is device-major (data major, shard minor
        — the P(('data','shard')) layout); block (bi, s) holds the
        compacted hits of device bi's local reads against source shard
        s. Local lane l < b_loc is forward strand (global read row
        bi*b_loc + l), else reverse (row Bp + bi*b_loc + l - b_loc)."""
        _, reads, Bp, k, out, level = handle
        hc, hn, hs, hcnt, hov, hco = jax.block_until_ready(out)
        n_dev = self.n_lanes  # local devices (this host's blocks only)
        S = self.mesh.shape["shard"]
        b_loc = Bp // n_dev
        mh, mc, _lf = self._caps(k, level)
        Ct = (k + 1) * mc if k else mh
        hc = self._get_local(hc).reshape(n_dev, S, -1)
        hn = self._get_local(hn).reshape(n_dev, S, -1)
        hs = self._get_local(hs).reshape(n_dev, S, -1)
        hcnt = self._get_local(hcnt).reshape(n_dev, S)
        co = int(self._get_local(hco).sum())
        hov = self._get_local(hov).reshape(n_dev, S, 2 * b_loc)
        n_over = int((hov.sum(axis=1) > 0).sum())
        # per-read truncation: read i lives on device i // b_loc at
        # local fwd lane i % b_loc, rev lane b_loc + i % b_loc
        ov2 = hov.sum(axis=1)  # (n_dev, 2*b_loc)
        trunc = (
            (ov2[:, :b_loc] + ov2[:, b_loc:]).reshape(-1) > 0
        )[: len(reads)]
        s_l, row_l, p_l, m_l = [], [], [], []
        for bi in range(n_dev):
            for s in range(S):
                cnt = int(hcnt[bi, s])
                sel = hs[bi, s, :cnt]
                nm = hn[bi, s, :cnt]
                cand = hc[bi, s, :cnt]
                keep = nm <= k
                sel, nm, cand = sel[keep], nm[keep], cand[keep]
                lane = sel // Ct
                fwd = lane < b_loc
                row = np.where(
                    fwd, bi * b_loc + lane, Bp + bi * b_loc + (lane - b_loc)
                )
                s_l.append(np.full(len(sel), s, dtype=np.int64))
                row_l.append(row)
                p_l.append(cand)
                m_l.append(nm)
        from bwtpu.engine import _assemble_flat

        hits = _assemble_flat(
            reads, Bp,
            np.concatenate(s_l), np.concatenate(row_l),
            np.concatenate(p_l).astype(np.int64), np.concatenate(m_l),
            [sh.text_len for sh in self.shards],
            [sh.shard_offset for sh in self.shards],
        )
        return hits, n_over, co, trunc

    def dispatch_batch(self, reads, k: int | None = None,
                       packed: bool | None = None, _level: int = 0):
        """Encode + launch one batch without materializing results;
        returns a handle for finish_batch. Several handles can be kept
        in flight (the devices execute dispatched programs in order, so
        pipelining never reorders collectives across hosts — every host
        dispatches the same programs in the same sequence).

        packed: None = auto-detect from this batch (single host). In a
        MULTI-HOST run the packed/ragged choice selects which collective
        program executes, so every host must pass the same explicit
        value (bwtpu.multihost agrees on it with an allgather up front)
        — auto-detect would deadlock hosts with differing batches."""
        k = self.config.k if k is None else k
        L = len(reads[0].seq) if reads else 0
        uniform = bool(
            reads
            and 0 < L <= self.config.read_len
            and all(len(r.seq) == L for r in reads)
        )
        if packed is None:
            packed = uniform
        elif packed and not uniform:
            raise ValueError("packed=True requires uniform-length reads")
        if packed:
            return self._dispatch_packed(reads, k, L, _level)
        if self.multiprocess:
            raise ValueError(
                "multi-process runs require uniform-length reads (the "
                "ragged ring stacks strands host-side, which does not "
                "shard host-contiguously); pad or trim the stream"
            )
        lanes = self.n_lanes
        # pad so the stacked-strand batch (2B rows) splits evenly over devices
        Bp = max(lanes, -(-len(reads) // lanes) * lanes)
        enc, B = encode_batch(self.config, reads, k, pad_to=Bp)
        batch2 = NamedSharding(self.mesh, P(("data", "shard"), None))
        b1 = NamedSharding(self.mesh, P(("data", "shard")))
        put2 = lambda x: jax.device_put(np.asarray(x), batch2)
        put1 = lambda x: jax.device_put(np.asarray(x), b1)

        if k == 0:
            d = pick_kmer_depth(self.kmer_depths, enc.min_len)
            fn = self._get_fn(k, d, _level)
            out = fn(
                self.dev.shard, put2(enc.ra_codes), put2(enc.ra_amb),
                put1(enc.lens),
            )
        else:
            d = pick_kmer_depth(self.kmer_depths, enc.min_seed_len)
            fn = self._get_fn(k, d, _level)
            out = fn(
                self.dev.shard,
                put2(enc.seed_ra), put2(enc.seed_amb), put1(enc.seed_lens),
                put1(enc.seed_off), put2(enc.read_words), put2(enc.amb_bits),
                put2(enc.len_mask), put1(enc.lens),
            )
        return ("ragged", reads, B, k, out, _level)

    def _finish_ragged(self, handle):
        _, reads, B, k, out, level = handle
        if k == 0:
            pos, valid, overflow, comp_over = jax.block_until_ready(out)
            nm = None
        else:
            pos, nm, valid, overflow, comp_over = jax.block_until_ready(out)
            nm = np.asarray(nm).transpose(1, 0, 2)

        co = int(np.asarray(comp_over).sum())
        ov = np.asarray(overflow)  # (B2, S) per-row counts
        n_over = int((ov.sum(axis=-1) > 0).sum())
        ovs = ov.sum(axis=-1)
        trunc = ((ovs[:B] + ovs[B:]) > 0)[: len(reads)]
        # (B2, S, H) -> (S, B2, H) to share the assembly helper
        pos = np.asarray(pos).transpose(1, 0, 2)
        valid = np.asarray(valid).transpose(1, 0, 2)
        hits = assemble_hits(
            reads, B, pos, nm, valid,
            [sh.text_len for sh in self.shards],
            [sh.shard_offset for sh in self.shards],
        )
        return hits, n_over, co, trunc

    def _overflow_agreed(self, bad: int) -> int:
        """Pod-wide overflow total: every process must take the same
        heal-or-not branch (the healed ring is a different collective
        program), so the local count is summed across processes with a
        host allgather (SURVEY.md §5.2 divergence rule)."""
        if not self.multiprocess:
            return bad
        from jax.experimental import multihost_utils

        return int(
            multihost_utils.process_allgather(np.array([bad])).sum()
        )

    def finish_batch(self, handle) -> list[list[Hit]]:
        tag, reads = handle[0], handle[1]
        k, level = handle[3], handle[5]
        if tag == "packed_compact":
            hits, n_over, co, trunc = self._finish_packed_compact(handle)
            packed = True
        elif tag == "packed":
            hits, n_over, co, trunc = self._finish_packed(handle)
            packed = True
        else:
            hits, n_over, co, trunc = self._finish_ragged(handle)
            packed = False
        cfg = self.config
        bad = self._overflow_agreed(n_over + co)
        if bad and cfg.heal_overflow and level < cfg.max_heals:
            # self-healing (VERDICT r3 item 3): same batch, doubled caps;
            # results are a superset, so they replace the originals.
            # Every process re-dispatches (agreement above), keeping the
            # collective program sequence identical pod-wide.
            self.heals += 1
            log.info(
                "dist align: %d overflowed rows / %d compaction drops — "
                "healing with 2^%d x caps", n_over, co, level + 1,
            )
            return self.finish_batch(
                self.dispatch_batch(reads, k, packed, _level=level + 1)
            )
        # final level: expose per-read truncation for the emit path
        # (innermost call of the heal recursion wins — that IS the
        # final level's run)
        self.last_truncated = trunc if n_over else None
        if co:
            log.warning(
                "dist align: compaction overflow by %d rows after %d "
                "heals — results may be incomplete", co, level,
            )
        if n_over:
            log.warning(
                "dist align: %d read-strand rows overflowed interval "
                "capacity after %d heals", n_over, level,
            )
        return hits

    def align_batch(
        self, reads, k: int | None = None, packed: bool | None = None
    ) -> list[list[Hit]]:
        return self.finish_batch(self.dispatch_batch(reads, k, packed))

    def align_all(
        self,
        reads,
        k: int | None = None,
        batch_size: int | None = None,
        pipeline_depth: int = 3,
        packed: bool | None = None,
    ) -> list[list[Hit]]:
        """Streamed alignment with `pipeline_depth` batches in flight —
        the dispatch/finish split mirrors Engine.align_all so host-side
        assembly overlaps ring hops (VERDICT r1 weak #4: a synchronous
        dispatch pays a fixed latency; S ring hops multiply it)."""
        bs = batch_size or self.config.batch_size
        out: list[list[Hit]] = []
        inflight: list = []
        for i in range(0, len(reads), bs):
            inflight.append(self.dispatch_batch(reads[i : i + bs], k, packed))
            if len(inflight) > pipeline_depth:
                out.extend(self.finish_batch(inflight.pop(0)))
        while inflight:
            out.extend(self.finish_batch(inflight.pop(0)))
        return out
