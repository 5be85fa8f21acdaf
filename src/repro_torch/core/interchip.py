"""Inter-chip bridge subsystem: compiled route programs across pod cuts.

The paper's last automated step (§III, Fig. 6) partitions the "on-chip" NoC
links so the same application runs across chips, with each cut link realized
over a narrow quasi-serial connection.  This module takes a
`routing.RouteProgram` plus a `partition.PartitionPlan` and splits it into
**per-pod programs joined by explicit bridge nodes** — one `BridgeLink` per
directed physical topology link the schedule drives across the cut.  Every
pod-crossing hop funnels its rotating-buffer traffic through a
`QuasiSerdesConfig`-framed serial link of ``lanes`` narrow beats, with a FIFO
depth and bandwidth model per bridge.

Three interpreters share the compiled `BridgedProgram`:

* :func:`simulate_bridged_program` — round-by-round execution on the message
  cube's device that really serializes every crossing buffer into wire words
  and back (lossless framing, so delivery is bit-identical to the uncut
  `routing.simulate_route_program`) and *defines* :class:`BridgeStats`:
  beats, serialized wire bytes, stall rounds (back-pressure + drain) and peak
  FIFO occupancy, per bridge and in total;
* :func:`bridge_program_stats` — the same stats from the static traversal
  schedule alone, with no data moved (the spmd executor's counters);
* :func:`run_bridged_program` — the device-mesh lowering: the program runs
  *linearized* over the mesh of `partition.mesh_for_partition` (``(pod,
  node)`` when the plan's pods are equal contiguous blocks); intra-pod hops
  stay one `collectives.ppermute`, cut hops go through
  `serdes.send_over_link` — encode, ``lanes`` serialized beat transfers,
  decode.

Both drive one FIFO machine (:class:`_BridgeSim`) that depends only on sizes,
never on values: the bridged simulation reads nothing back from the device,
and its index lists reach the device once (`routing._index`).  Both take a
telemetry ``tracer=``; the machine emits the ``bridge_*`` events, so the two
give one event stream.

Bridge cost model
-----------------
A bridge serializes each crossing buffer into ``ceil(bytes / beat_bytes)``
wire words, padded to a multiple of ``lanes``.  Words enqueue into the bridge
FIFO in the NoC round they arrive; the bridge drains ``lanes`` words a round.
Occupancy beyond ``fifo_depth`` back-pressures the pod-synchronous schedule —
those are stall rounds, as is the final drain after the last program round.
``beats`` counts serial-lane cycles spent transmitting (``words / lanes`` per
crossing).  The data path is always lossless: compression is a planning knob
of the cut objective, never a transform of in-flight flit bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch

from . import serdes as qserdes
from .collectives import MeshAxis, NoCMesh, all_to_all, ppermute
from .partition import PartitionPlan
from .routing import (HopMove, LinePhase, RouteProgram, ScheduleStats, _index,
                      _line_compiled, _nbytes, route_program_stats, run_route_program)


@dataclasses.dataclass(frozen=True)
class BridgeConfig:
    """Per-bridge serial-link model: serdes framing + FIFO depth (in wire
    words).  ``serdes.compress`` only shapes planning costs; the bridge data
    path always moves the exact flit bytes."""

    serdes: qserdes.QuasiSerdesConfig = dataclasses.field(
        default_factory=qserdes.QuasiSerdesConfig)
    fifo_depth: int = 64

    def __post_init__(self):
        if self.fifo_depth < 1:
            raise ValueError(f"fifo_depth must be >= 1, got {self.fifo_depth}")


@dataclasses.dataclass(frozen=True)
class BridgeLink:
    """One directed physical topology link cut by the partition."""

    src: int
    dst: int
    src_pod: int
    dst_pod: int


@dataclasses.dataclass(frozen=True)
class BridgedRound:
    """One NoC round of the partitioned schedule: physical link traversals
    split at the cut.  Every traversal moves ``cube_nbytes // den`` bytes."""

    den: int
    intra: tuple[tuple[int, int], ...]     # on-chip (src, dst) node pairs
    cross: tuple[int, ...]                 # bridge indices carrying traffic


@dataclasses.dataclass(frozen=True)
class PodProgram:
    """The per-pod view of the split schedule: the hops that stay on this
    chip plus the bridges stitched to its boundary."""

    pod: int
    nodes: tuple[int, ...]
    rounds: tuple[tuple[tuple[int, int], ...], ...]   # intra hops per round
    egress: tuple[int, ...]                # bridge indices leaving this pod
    ingress: tuple[int, ...]               # bridge indices entering this pod


@dataclasses.dataclass(frozen=True)
class BridgedProgram:
    """A RouteProgram split across a pod cut: per-pod programs + bridges."""

    prog: RouteProgram
    pod_of_node: tuple[int, ...]
    bridges: tuple[BridgeLink, ...]
    rounds: tuple[BridgedRound, ...]
    pods: tuple[PodProgram, ...]
    cfg: BridgeConfig
    wire_cfg: qserdes.QuasiSerdesConfig    # cfg.serdes with compression off

    @property
    def n_pods(self) -> int:
        return len(self.pods)


@dataclasses.dataclass
class BridgeStats:
    """Serial-link accounting of one partitioned execution (value-independent)."""

    n_bridges: int = 0
    beats: int = 0            # serial-lane clock cycles spent transmitting
    wire_bytes: int = 0       # serialized bytes incl. word/lane padding
    stall_rounds: int = 0     # back-pressure + final-drain rounds
    peak_fifo: int = 0        # max FIFO occupancy over bridges, in wire words
    per_bridge: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# compile: split a RouteProgram at the cut
# ---------------------------------------------------------------------------

def _walk_rounds(prog: RouteProgram) -> Iterator[tuple[int, list[tuple[int, int]]]]:
    """Yield ``(den, physical (src, dst) link traversals)`` per NoC round, in
    execution order, with axis-local hop pairs expanded to global node ids;
    each traversal moves ``cube_nbytes // den`` bytes of the message cube."""
    n = prog.n_nodes
    if prog.fused:
        yield n * n, [(s, d) for s in range(n) for d in range(n) if s != d]
        return
    if len(prog.phases) == 1:
        for rnd in prog.phases[0].rounds:
            yield n, [p for mv in rnd.moves for p in mv.perm]
        return
    (_, ry), (_, rx) = prog.axes
    phase_x, phase_y = prog.phases
    for rnd in phase_x.rounds:
        yield n, [(y * rx + s, y * rx + d)
                  for mv in rnd.moves for s, d in mv.perm for y in range(ry)]
    for rnd in phase_y.rounds:
        yield n, [(s * rx + x, d * rx + x)
                  for mv in rnd.moves for s, d in mv.perm for x in range(rx)]


def compile_bridges(prog: RouteProgram, plan: PartitionPlan,
                    cfg: Optional[BridgeConfig] = None) -> BridgedProgram:
    """Split a compiled route program at a partition plan's pod cut."""
    pod_of = tuple(plan.pod_of_node)
    if len(pod_of) != prog.n_nodes:
        raise ValueError(f"plan covers {len(pod_of)} nodes, "
                         f"program has {prog.n_nodes}")
    cfg = cfg or BridgeConfig(serdes=plan.serdes_cfg)
    wire_cfg = dataclasses.replace(cfg.serdes, compress="none")
    bridges: list[BridgeLink] = []
    bridge_of: dict[tuple[int, int], int] = {}
    rounds: list[BridgedRound] = []
    for den, pairs in _walk_rounds(prog):
        intra, cross = [], []
        for s, d in pairs:
            if pod_of[s] == pod_of[d]:
                intra.append((s, d))
            else:
                if (s, d) not in bridge_of:
                    bridge_of[(s, d)] = len(bridges)
                    bridges.append(BridgeLink(s, d, pod_of[s], pod_of[d]))
                cross.append(bridge_of[(s, d)])
        rounds.append(BridgedRound(den, tuple(intra), tuple(cross)))
    n_pods = max(pod_of) + 1 if pod_of else 1
    pods = tuple(
        PodProgram(
            p,
            tuple(i for i in range(prog.n_nodes) if pod_of[i] == p),
            tuple(tuple(pr for pr in r.intra if pod_of[pr[0]] == p) for r in rounds),
            tuple(i for i, b in enumerate(bridges) if b.src_pod == p),
            tuple(i for i, b in enumerate(bridges) if b.dst_pod == p),
        )
        for p in range(n_pods))
    return BridgedProgram(prog, pod_of, tuple(bridges), tuple(rounds), pods, cfg, wire_cfg)


# ---------------------------------------------------------------------------
# bridge FIFO / bandwidth model (shared by the simulator and the analytic stats)
# ---------------------------------------------------------------------------

class _BridgeSim:
    """FIFO + serialization model of every bridge, advanced round by round.

    Per bridge and round: crossing frames land in the upstream router output
    (``pending``); the FIFO admits from it up to ``fifo_depth`` and transmits
    ``lanes`` words.  While upstream words remain un-admitted after the
    scheduled round, the synchronous schedule *stalls* (the slowest bridge
    gates every pod), repeating admit+transmit rounds; the final FIFO drain
    after the last program round stalls the same way.

    ``tracer`` (a `telemetry.Tracer`, optional) records the machine's
    ``bridge_cfg``/``bridge_tx``/``bridge_fifo``/``bridge_stall`` events at
    ``tracer.clock + round``.  One machine is one trace source, shared by the
    simulator and the analytic stats, which is why their event streams
    agree."""

    def __init__(self, bprog: BridgedProgram, tracer=None):
        self.cfg = bprog.cfg
        self.keys = [(b.src, b.dst) for b in bprog.bridges]
        self.links = [dict(occ=0, pending=0, peak=0, words=0, beats=0, stalls=0)
                      for _ in bprog.bridges]
        self.stall_rounds = 0
        self.tracer = tracer
        self._t0 = tracer.clock if tracer is not None else 0
        self._round = 0
        if tracer is not None and self.links:
            tracer.instant("bridge_cfg", "bridges", ts=self._t0,
                           n=len(self.links), **self.cfg.serdes.trace_args())

    def words_for(self, nbytes: int) -> int:
        """Wire words one crossing of ``nbytes`` occupies: ceil to whole
        words, padded so the frame splits evenly into lanes."""
        s = self.cfg.serdes
        n_words = -(-nbytes // s.beat_bytes)
        return -(-n_words // s.lanes) * s.lanes

    def push(self, bridge_idx: int, nbytes: int) -> None:
        s = self.cfg.serdes
        w = self.words_for(nbytes)
        lk = self.links[bridge_idx]
        lk["pending"] += w
        lk["words"] += w
        lk["beats"] += w // s.lanes
        if self.tracer is not None:
            bs, bd = self.keys[bridge_idx]
            self.tracer.instant("bridge_tx", f"bridge {bs}->{bd}",
                                ts=self._t0 + self._round, words=w,
                                beats=w // s.lanes, wire_bytes=w * s.beat_bytes)

    def _admit_transmit(self, idx: int, lk: dict) -> None:
        take = min(lk["pending"], self.cfg.fifo_depth - lk["occ"])
        lk["occ"] += take
        lk["pending"] -= take
        lk["peak"] = max(lk["peak"], lk["occ"])
        if self.tracer is not None:
            # post-admit, pre-transmit: the peak-update point, so the counter
            # track's max IS bridge_peak_fifo
            bs, bd = self.keys[idx]
            self.tracer.counter("bridge_fifo", f"bridge {bs}->{bd}", lk["occ"],
                                ts=self._t0 + self._round)
        lk["occ"] = max(0, lk["occ"] - self.cfg.serdes.lanes)

    def _trace_stall(self, rounds: int, gating: int) -> None:
        """The slowest bridge gates the synchronous schedule: the event names
        it, so the profiler charges the stall to that bridge."""
        if self.tracer is not None and rounds:
            bs, bd = self.keys[gating]
            self.tracer.instant("bridge_stall", "bridges", ts=self._t0 + self._round,
                                rounds=rounds, src=bs, dst=bd)

    def end_round(self) -> None:
        round_stall, gating = 0, -1
        for idx, lk in enumerate(self.links):
            self._admit_transmit(idx, lk)
            s = 0
            while lk["pending"]:
                self._admit_transmit(idx, lk)
                s += 1
            lk["stalls"] += s
            if s > round_stall:
                round_stall, gating = s, idx
        self.stall_rounds += round_stall
        self._trace_stall(round_stall, gating)
        self._round += 1

    def finish(self) -> BridgeStats:
        lanes = self.cfg.serdes.lanes
        beat_b = self.cfg.serdes.beat_bytes
        drain, gating = 0, -1
        for idx, lk in enumerate(self.links):
            s = -(-lk["occ"] // lanes)
            lk["stalls"] += s
            while self.tracer is not None and lk["occ"] > 0:
                self._admit_transmit(idx, lk)   # traced terminal drain
            lk["occ"] = 0
            if s > drain:
                drain, gating = s, idx
        self.stall_rounds += drain
        self._trace_stall(drain, gating)
        per = {k: dict(beats=lk["beats"], wire_bytes=lk["words"] * beat_b,
                       stall_rounds=lk["stalls"], peak_fifo=lk["peak"])
               for k, lk in zip(self.keys, self.links)}
        return BridgeStats(
            n_bridges=len(self.links),
            beats=sum(lk["beats"] for lk in self.links),
            wire_bytes=sum(lk["words"] for lk in self.links) * beat_b,
            stall_rounds=self.stall_rounds,
            peak_fifo=max((lk["peak"] for lk in self.links), default=0),
            per_bridge=per)


def bridge_program_stats(bprog: BridgedProgram, cube_nbytes: int,
                         tracer=None) -> BridgeStats:
    """Analytic BridgeStats for moving one ``cube_nbytes`` message cube
    through a bridged program — exactly what :func:`simulate_bridged_program`
    counts (same arrival schedule, same FIFO machine, no data moved).
    ``tracer`` records the per-round ``bridge_tx``/``bridge_fifo``/
    ``bridge_stall`` events of that shared machine."""
    sim = _BridgeSim(bprog, tracer)
    for rnd in bprog.rounds:
        per = cube_nbytes // rnd.den
        for bidx in rnd.cross:
            sim.push(bidx, per)
        sim.end_round()
    return sim.finish()


# ---------------------------------------------------------------------------
# round-by-round simulator (physical serialization on the cube's device)
# ---------------------------------------------------------------------------

def _wire_roundtrip(segs: torch.Tensor, br: _BridgeSim, bridge_idx: list[int]) -> torch.Tensor:
    """Serialize crossing buffers: ``segs`` (n_cross, *seg) bytes → each
    padded to whole wire words (the beats on the narrow link), viewed as the
    wire's type, viewed back to bytes and cut to length — what the far
    endpoint reconstructs.  One crossing per row, all in one pass."""
    s = br.cfg.serdes
    nbytes = segs[0].numel()
    padded = torch.zeros((segs.shape[0], br.words_for(nbytes) * s.beat_bytes),
                         dtype=torch.uint8, device=segs.device)
    padded[:, :nbytes] = segs.reshape(segs.shape[0], -1)
    words = padded.view(qserdes._WIRE_DTYPES[s.wire_bits])
    for b in bridge_idx:
        br.push(b, nbytes)
    return words.view(torch.uint8)[:, :nbytes].reshape(segs.shape)


def _line_bridged(buf: torch.Tensor, phase: LinePhase, phys, pod_of, bridge_of,
                  br: _BridgeSim, stats: ScheduleStats) -> torch.Tensor:
    """`routing._line_compiled` with the hop transport split at the cut.

    ``buf``: (m, m, R, k) — (axis holder, axis destination, physical row,
    payload bytes); ``phys(row, axis_pos)`` maps to the global node id, so
    each (s, d) hop of the axis perm is R physical link traversals.  Each move
    serializes all of its crossing rows in one pass (:func:`_wire_roundtrip`)."""
    R = buf.shape[2]
    dev = buf.device

    def on_move(mv: HopMove, nxt: torch.Tensor) -> torch.Tensor:
        cross = [(d, r, bridge_of[(phys(r, s), phys(r, d))])
                 for s, d in mv.perm for r in range(R)
                 if pod_of[phys(r, s)] != pod_of[phys(r, d)]]
        if cross:
            di = _index(tuple(c[0] for c in cross), dev)
            ri = _index(tuple(c[1] for c in cross), dev)
            nxt[di, :, ri] = _wire_roundtrip(nxt[di, :, ri], br, [c[2] for c in cross])
        return nxt

    return _line_compiled(buf, phase, stats, on_move, br.end_round)


def simulate_bridged_program(bprog: BridgedProgram, msgs: torch.Tensor, *,
                             batched: bool = False, tracer=None,
                             ) -> tuple[torch.Tensor, ScheduleStats, BridgeStats]:
    """Round-by-round execution of a partitioned program on ``msgs``' device.

    msgs: (n_src, n_dst, *c) → (delivered (n_dst, n_src, *c), schedule stats,
    bridge stats).  Delivery and ScheduleStats are bit-identical to the uncut
    `routing.simulate_route_program`; only the BridgeStats record what the
    serial links did.  ``batched=True`` folds a leading batch axis into the
    payload (rounds counted once, bytes scale with B).  ``tracer`` records
    the bridge machine's events, as in :func:`bridge_program_stats`."""
    if batched:
        if msgs.ndim < 3:
            raise ValueError("batched msgs must be (B, n_src, n_dst, *c)")
        inner = torch.movedim(msgs, 0, 2).contiguous()
        delivered, stats, bstats = simulate_bridged_program(bprog, inner, tracer=tracer)
        return torch.movedim(delivered, 2, 0).contiguous(), stats, bstats
    prog = bprog.prog
    n = prog.n_nodes
    if msgs.shape[0] != n or msgs.shape[1] != n:
        raise ValueError(f"msgs {tuple(msgs.shape)} is not (n, n, ...) for n={n}")
    pod_of = bprog.pod_of_node
    bridge_of = {(b.src, b.dst): i for i, b in enumerate(bprog.bridges)}
    stats = ScheduleStats()
    br = _BridgeSim(bprog, tracer)
    raw = msgs.contiguous()
    byte = raw.view(torch.uint8).reshape(n, n, -1)
    k = byte.shape[2]

    def unview(b: torch.Tensor) -> torch.Tensor:
        return b.contiguous().view(raw.dtype).reshape(raw.shape)

    if prog.fused:
        # one crossbar round: every cut (s, d) chunk crosses its link directly
        out = byte.transpose(0, 1).contiguous()
        st = route_program_stats(prog, _nbytes(byte))
        stats.rounds, stats.link_bytes = st.rounds, st.link_bytes
        cross = sorted(bridge_of.items())
        if cross:
            di = _index(tuple(d for (_, d), _ in cross), out.device)
            si = _index(tuple(s for (s, _), _ in cross), out.device)
            out[di, si] = _wire_roundtrip(out[di, si], br, [b for _, b in cross])
        br.end_round()
        return unview(out), stats, br.finish()
    if len(prog.phases) == 1:
        out = _line_bridged(byte.reshape(n, n, 1, k), prog.phases[0],
                            lambda r, i: i, pod_of, bridge_of, br, stats)
        return unview(out.reshape(n, n, k)), stats, br.finish()
    # 2D XY routing: the factorized data motion of simulate_route_program,
    # with the physical row kept explicit so each hop splits at the cut
    (_, ry), (_, rx) = prog.axes
    phase_x, phase_y = prog.phases
    m = byte.reshape(ry, rx, ry, rx, k)
    b = torch.movedim(m, (1, 3), (0, 1))              # [sx, dx, sy, dy, k]
    b = _line_bridged(b.contiguous().reshape(rx, rx, ry, -1), phase_x,
                      lambda r, x: r * rx + x, pod_of, bridge_of, br, stats)
    b = b.reshape(rx, rx, ry, ry, k)                  # [dx(node), sx, sy, dy, k]
    b = torch.movedim(b, (2, 3), (0, 1))              # [sy, dy, dx, sx, k]
    b = _line_bridged(b.contiguous().reshape(ry, ry, rx, -1), phase_y,
                      lambda r, y: y * rx + r, pod_of, bridge_of, br, stats)
    b = b.reshape(ry, ry, rx, rx, k)                  # [dy(node), sy, dx, sx, k]
    out = torch.movedim(b, (0, 2, 1, 3), (0, 1, 2, 3))
    return unview(out.contiguous().reshape(n, n, k)), stats, br.finish()


# ---------------------------------------------------------------------------
# device-mesh lowering (spmd execution of the partitioned program)
# ---------------------------------------------------------------------------

def _bridged_transfer(bprog: BridgedProgram, axis: MeshAxis):
    """Hop transport for `routing.run_route_program(transfer=...)` over the
    flat ``axis``: intra-pod pairs stay one ppermute; cut pairs go through
    serdes endpoints — encode, ``lanes`` serialized beat transfers, decode
    (`serdes.send_over_link`).  A rank that no pair reaches gets zeros."""
    pod_of = bprog.pod_of_node

    def transfer(buf: torch.Tensor, pairs) -> torch.Tensor:
        intra = [(s, d) for s, d in pairs if pod_of[s] == pod_of[d]]
        cross = [(s, d) for s, d in pairs if pod_of[s] != pod_of[d]]
        out = ppermute(buf, axis, intra) if intra else torch.zeros_like(buf)
        if cross:
            rec, _ = qserdes.send_over_link(buf, axis, cross, bprog.wire_cfg, serialized=True)
            if any(d == axis.coord for _, d in cross):
                out = rec
        return out

    return transfer


def _bridged_crossbar(x: torch.Tensor, bprog: BridgedProgram, axis: MeshAxis) -> torch.Tensor:
    """Fat-tree/crossbar round split at the cut: intra chunks ride the fused
    all_to_all; every chunk is also serialized into wire words whose beats
    move through ``lanes`` separate all_to_alls, and the chunks that arrive
    over a cut link are the decoded ones."""
    n = bprog.prog.n_nodes
    pod_of = bprog.pod_of_node
    out = all_to_all(x, axis)
    if not any(pod_of[s] != pod_of[d] for s in range(n) for d in range(n)):
        return out
    cfg = bprog.wire_cfg
    meta = qserdes.plan(tuple(x.shape[1:]), x.dtype, cfg)
    enc = torch.stack([qserdes.encode(row, cfg, meta)[0].view(torch.uint8) for row in x])
    beats = [all_to_all(enc[:, ln], axis) for ln in range(cfg.lanes)]   # (n_src, w bytes)
    words = torch.stack(beats, dim=1)                                   # (n_src, lanes, w bytes)
    no_scales = torch.zeros((cfg.lanes, 0), dtype=torch.uint8, device=x.device)
    i = axis.coord
    for s in range(n):
        if pod_of[s] != pod_of[i]:       # the chunk from s came over a cut link
            out[s] = qserdes.decode(words[s], no_scales, cfg, meta)
    return out


def run_bridged_program(x: torch.Tensor, bprog: BridgedProgram, mesh: NoCMesh,
                        axis_name) -> torch.Tensor:
    """Execute a partitioned program on this rank's row of the cube.

    Same per-rank contract as `routing.run_route_program` — ``x`` is the
    ``(n, *chunk)`` destination-indexed row, returns the source-indexed row
    received — but always *linearized* over ``axis_name`` (a mesh axis name
    or tuple, e.g. ``("pod", "node")`` from `partition.mesh_for_partition`,
    where the flat index IS the global NoC node id).  Intra-pod hops are
    plain ppermute rounds; pod-crossing hops move through quasi-SERDES
    endpoints.  Bit-identical to the uncut program: the wire framing is
    lossless."""
    axis = mesh.axis(axis_name)
    if bprog.prog.fused:
        return _bridged_crossbar(x, bprog, axis)
    return run_route_program(x, bprog.prog, mesh, axis_name=axis_name,
                             transfer=_bridged_transfer(bprog, axis))
