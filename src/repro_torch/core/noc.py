"""NoC executor: run a TaskGraph over a Topology, optionally cut across pods
(port of ``repro.core.noc``).

PEs from phase 1 (`core.graph`) are placed on a CONNECT-style topology
(`core.topology`, `core.partition`) and every message moves through the
topology's routing schedule (`core.routing`) as bytes of a device-resident
``(n, n, buf_bytes)`` uint8 message cube.

Modes of this port:

* ``direct``     — `TaskGraph.run`, the pure-software oracle.  No NoC, no stats.
* ``sim``        — the compiled **flit-program engine**: PEs fire wave by wave
  and each wave's messages are framed into the cube with one scatter, moved
  round by round with `simulate_schedule`, and gathered back with one gather.
  Outputs equal ``direct`` bit for bit; `NoCStats` equal the reference's
  field for field.
* ``spmd``       — the **device-mesh execution** of the same compiled flit
  program over ``torch.distributed``: one NoC node per rank of the default
  process group (`partition.mesh_for_topology`), each wave's message cube
  moved by the topology's compiled route program
  (`routing.run_route_program`) — one point-to-point transfer per hop move,
  fat-tree as one ``all_to_all_single``.  Outputs and `NoCStats` equal
  ``sim``'s: rounds and link bytes come from `routing.route_program_stats`,
  which counts exactly what the round-by-round simulator counts.  Needs
  ``n_nodes`` ranks (``torchrun --nproc-per-node``); see below.
* ``sim_python`` — the seed per-message loop (framing re-derived every wave,
  one copy per message), the baseline the engine is held against: the same
  outputs and `NoCStats` as ``sim``.
* ``buffered``   — the **contention-aware wormhole transport** (`core.switch`):
  each wave's message cube moves flit by flit through per-port input FIFOs
  (``NoCConfig.switch_buffer_depth``) with X-Y dimension-ordered routing,
  round-robin output arbitration, credit backpressure and dateline virtual
  channels (``switch_vcs``).  Equal to ``sim`` in outputs, ``waves``,
  ``payload_bytes``, ``flits`` and the ``cross_pod_*`` counters.
  Mode-specific: ``rounds`` counts switch *cycles*, ``link_bytes`` counts
  flit-hops × flit wire bytes, and the ``switch_*`` counters are populated.
  The cycle machine is host bookkeeping; the cube stays on the device and is
  delivered with one gather and one scatter per wave.  With ``plan=`` it
  routes uncut and rolls the analytic bridge counters, like ``sim_python``.

``run_batch`` moves B independent input sets through one ``(B, n, n, bytes)``
simulation (PEs fire per input set), and ``run_iterative`` reuses the
compiled program across iterations; both take ``mode="spmd"`` and
``mode="buffered"`` too.  PEs fire eagerly on the executor's device.

Device-mesh execution (``mode="spmd"``)
---------------------------------------
The reference is single-controller: its controller fires every PE, and only
the wave's message cube is sharded over the device mesh inside
``shard_map``.  The port is SPMD in torch's sense: every rank of the default
process group calls the same ``run(..., mode="spmd")`` on the same inputs and
fires every PE (replicated, as the controller does), then sends its own
node's row of the cube through the route program and assembles the delivered
cube with an ``all_gather`` of the rows (`collectives.NoCMesh.gather_nodes`),
so every rank returns the same outputs and the same `NoCStats`.  Rank ``i``
is NoC node ``i``, row-major over ``(noc_y, noc_x)``; the NoC group is the
first ``n_nodes`` ranks of the default group, and ranks past them compute
the same results.  Without an initialized group, or with too few ranks,
``RuntimeError`` names ``torchrun --nproc-per-node``.  The transport
semantics (zeros where no pair arrives, host staging of CUDA tensors under
gloo) are `core.collectives`'.  With ``plan=`` the cube moves through
`interchip.run_bridged_program` over `partition.mesh_for_partition`: intra-pod
hops stay single transfers, cut hops run serdes encode → ``lanes``
serialized beat transfers → decode, and the bridge counters are the analytic
`interchip.bridge_program_stats`, which equal the simulator's.

Partitioned execution (``plan=``)
---------------------------------
A `partition.PartitionPlan` splits the compiled route program at the pod cut
into per-pod programs joined by bridge endpoints (`core.interchip`): every
pod-crossing hop serializes its traffic through a quasi-SERDES link of
``lanes`` narrow beats with a FIFO of ``NoCConfig.bridge_fifo_depth`` words.
The cut is transparent: outputs and every pre-existing `NoCStats` field are
identical to the uncut run; the static ``cross_pod_*`` counters count the
messages that cross, and the ``bridge_*`` counters record what the serial
links did.  ``sim`` and ``run_batch`` really serialize every crossing buffer
(`interchip.simulate_bridged_program`); ``spmd`` serializes them between
ranks (`interchip.run_bridged_program`); ``sim_python`` routes uncut and rolls
in the analytic `interchip.bridge_program_stats`, which equal the simulator's.

Static verification (``verify=``)
---------------------------------
``NoCExecutor(verify="strict")`` (the default) runs
`analysis.verify_executor` over the artifacts it just compiled: the deadlock
proof of ``(topo, cfg.switch_vcs)``, exactly-once delivery of the route
program, the bridged pod projections and every wave's pack/gather layout,
placement/cut/config validity and capacity bounds.  ``"strict"`` raises
`analysis.VerificationError` on any error, ``"warn"`` warns, ``"off"`` skips;
the diagnostics are kept on ``self.verification``.  The verifier reads host
copies of the compiled layouts only.

Telemetry (``trace=``)
----------------------
``NoCExecutor(trace=telemetry.Tracer())`` (or ``trace=True``) threads an event
tracer through every mode: one ``run`` instant per run, one ``msg`` instant
per compiled message slot (with the cross-pod wire cost when it crosses the
cut), per-round ``round``/``link`` events from the compiled route program for
the schedule transports, the switch's per-cycle events in ``buffered``, the
bridge machine's ``bridge_*`` events under a plan, and per-wave
``scatter``/``route``/``gather``/``wave`` spans on a logical clock (scatter 1
tick, route = rounds or switch cycles + bridge stall rounds, gather 1 tick;
a message-free wave is a 2-tick span).  The events equal the reference's
event for event, and `telemetry.trace_stats` folds them back into the run's
`NoCStats` field for field.  ``trace=None`` (the default) allocates no event:
every hook is one ``is not None`` check.  Independently of tracing, each run
publishes its `NoCStats` into the process-wide registry when one is enabled
(`telemetry.enable_metrics`), labeled by ``mode`` and ``topology``.

The flit-program compile step
-----------------------------
Every channel's shape/dtype is a declared contract, so the framing of a wave
is known when the executor is built.  ``NoCExecutor.__init__`` compiles, per
wave, a :class:`_WaveProgram`: the flit-padded byte offset of every message in
its (src, dst) node buffer (``flit_data_width`` granularity), flat
``pack_idx``/``gather_idx`` device index vectors into the cube and the
delivered ``(n_dst, n_src, buf_bytes)`` cube (with host copies for the
verifier), the occupied ``(src, dst, framed_bytes)`` pairs, and the wave's
value-independent `NoCStats` increment (payload bytes, flits, cross-pod
messages and wire bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..telemetry.metrics import get_registry
from ..telemetry.tracer import Tracer
from . import serdes as qserdes
from .graph import GraphError, TaskGraph, torch_dtype
from .interchip import (BridgeConfig, BridgedProgram, _walk_rounds, bridge_program_stats,
                        compile_bridges, run_bridged_program, simulate_bridged_program)
from .partition import PartitionPlan, mesh_for_partition, mesh_for_topology, place_round_robin
from .routing import (_nbytes, compile_routes, route_program_stats, run_route_program,
                      simulate_schedule)
from .switch import SwitchConfig, dor_route, simulate_wormhole_cube
from .topology import Topology


@dataclasses.dataclass
class NoCStats:
    waves: int = 0
    rounds: int = 0
    link_bytes: int = 0
    payload_bytes: int = 0
    flits: int = 0
    cross_pod_msgs: int = 0
    cross_pod_wire_bytes: int = 0
    cross_pod_beats: int = 0
    # bridge counters — nonzero only under partitioned execution (plan=)
    bridge_beats: int = 0
    bridge_wire_bytes: int = 0
    bridge_stall_rounds: int = 0
    bridge_peak_fifo: int = 0
    # buffered-switch counters — nonzero only in mode="buffered"
    switch_cycles: int = 0
    switch_stall_cycles: int = 0
    switch_arb_losses: int = 0
    switch_max_queue: int = 0
    switch_peak_link_flits: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def add(self, other: "NoCStats") -> "NoCStats":
        for f in dataclasses.fields(NoCStats):
            a, b = getattr(self, f.name), getattr(other, f.name)
            # peak occupancies are high-water marks, not flows — merge by max
            setattr(self, f.name,
                    max(a, b) if f.name in _MAX_MERGE_FIELDS else a + b)
        return self

    def bridge_counters(self) -> dict:
        return {k: v for k, v in self.as_dict().items() if k.startswith("bridge_")}

    def _roll_bridge(self, b) -> None:
        """Fold one wave's BridgeStats in (peak merged by max)."""
        self.bridge_beats += b.beats
        self.bridge_wire_bytes += b.wire_bytes
        self.bridge_stall_rounds += b.stall_rounds
        self.bridge_peak_fifo = max(self.bridge_peak_fifo, b.peak_fifo)

    def _roll_switch(self, sw) -> None:
        """Fold one wave's SwitchStats in (peaks merged by max)."""
        self.switch_cycles += sw.cycles
        self.switch_stall_cycles += sw.stall_cycles
        self.switch_arb_losses += sw.arb_losses
        self.switch_max_queue = max(self.switch_max_queue, sw.max_queue)
        self.switch_peak_link_flits = max(self.switch_peak_link_flits,
                                          sw.peak_link_flits)


# high-water-mark fields: NoCStats.add merges these by max, not sum
_MAX_MERGE_FIELDS = frozenset(
    {"bridge_peak_fifo", "switch_max_queue", "switch_peak_link_flits"})


@dataclasses.dataclass(frozen=True)
class NoCConfig:
    """CONNECT "Network and Router Options" analog (paper §VI-B).  The switch
    fields configure ``mode="buffered"`` (`core.switch`)."""

    flit_data_width: int = 16          # bits
    flit_buffer_depth: int = 8         # per-(src, expert) FIFO depth, in slots
    bridge_fifo_depth: int = 64        # inter-chip bridge FIFO, in wire words
    switch_buffer_depth: int = 4       # buffered mode: input FIFO depth, flits
    switch_vcs: int = 2                # buffered mode: VCs per input port
    serdes: qserdes.QuasiSerdesConfig = dataclasses.field(
        default_factory=qserdes.QuasiSerdesConfig)

    def __post_init__(self):
        for f in ("flit_data_width", "flit_buffer_depth", "bridge_fifo_depth",
                  "switch_buffer_depth", "switch_vcs"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"NOC012: NoCConfig.{f}={v!r} must be a "
                                 f"positive integer")

    @property
    def flit_wire_bytes(self) -> int:
        """On-wire/storage bytes of ONE flit: ceil(width/8)."""
        return -(-self.flit_data_width // 8)

    def flits_for(self, nbytes: int) -> int:
        # payload capacity of a flit is the whole bytes it can carry (floor),
        # never 0 for sub-byte widths
        per = max(1, self.flit_data_width // 8)
        return -(-nbytes // per)

    def flit_framed_bytes(self, nbytes: int) -> int:
        """THE flit-framing rule: payload bytes → on-link/FIFO bytes (whole
        flits × ceiling flit storage)."""
        return self.flits_for(nbytes) * self.flit_wire_bytes


def wrapper_overhead(graph: TaskGraph, cfg: Optional[NoCConfig] = None) -> list[dict]:
    """Tables I–III analog: per-PE cost without vs with the NoC wrapper."""
    cfg = cfg or NoCConfig()
    rows = []
    for pe in graph.pes.values():
        in_b = sum(p.nbytes for p in pe.inputs)
        out_b = sum(p.nbytes for p in pe.outputs)
        raw = in_b + out_b
        fifo = cfg.flit_buffer_depth * cfg.flit_wire_bytes * (len(pe.inputs) + len(pe.outputs))
        flit_b = sum(cfg.flit_framed_bytes(p.nbytes)
                     for p in list(pe.inputs) + list(pe.outputs))
        rows.append(dict(pe=pe.name, wo_wrapper_bytes=raw, fifo_bytes=fifo,
                         flit_bytes=flit_b, with_wrapper_bytes=flit_b + fifo,
                         overhead=round((flit_b + fifo - raw) / max(raw, 1), 3)))
    return rows


# ---------------------------------------------------------------------------
# compiled flit program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _MsgSlot:
    """One channel message inside a wave's compiled layout."""

    src_pe: str
    src_port: str
    dst_pe: str
    dst_port: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    nbytes: int
    a: int                 # [a:b) segment in the wave's payload byte vector
    b: int


@dataclasses.dataclass(frozen=True)
class _WaveProgram:
    """Static framing layout of one wave (compiled at executor construction)."""

    slots: tuple[_MsgSlot, ...]
    payload_nbytes: int       # Σ raw message bytes (the payload vector length)
    buf_bytes: int            # per-(src,dst) buffer size incl. flit padding
    pack_idx: torch.Tensor    # flat indices into (n, n, buf_bytes) per payload byte
    gather_idx: torch.Tensor  # flat indices into delivered (n_dst, n_src, buf_bytes)
    static: NoCStats          # value-independent stats increment for this wave
    pairs: tuple[tuple[int, int, int], ...]  # occupied (src, dst, framed_bytes)
    pack_host: np.ndarray     # host copies of the index vectors (the verifier's)
    gather_host: np.ndarray


def _stack(ts: list[torch.Tensor]) -> torch.Tensor:
    """torch.stack for any dtype: the unsigned 16/32/64-bit types are stacked
    through a same-width signed view (their op coverage is thin on CUDA)."""
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}.get(ts[0].dtype)
    if signed is None:
        return torch.stack(ts)
    return torch.stack([t.view(signed) for t in ts]).view(ts[0].dtype)


class NoCExecutor:
    def __init__(self, graph: TaskGraph, topo: Topology,
                 placement: Optional[Mapping[str, int]] = None,
                 plan: Optional[PartitionPlan] = None,
                 cfg: Optional[NoCConfig] = None,
                 verify: str = "strict",
                 trace: Optional[Any] = None,
                 device="cuda"):
        if verify not in ("strict", "warn", "off"):
            raise ValueError(f"verify must be 'strict', 'warn', or 'off', got {verify!r}")
        # trace: None (off) | a telemetry Tracer | True for a default one; shared
        # across runs, so run_iterative/run_batch build one continuous timeline
        self.tracer = Tracer() if trace is True else trace
        self.device = resolve_device(device)
        self.graph = graph
        self.topo = topo
        self.placement = dict(placement or (plan.placement if plan
                                            else place_round_robin(graph, topo)))
        self.plan = plan
        self.cfg = cfg or NoCConfig()
        graph.validate()
        self._order = graph.firing_order()
        # group PEs into waves by dataflow depth
        depth: dict[str, int] = {}
        preds: dict[str, set[str]] = {n: set() for n in graph.pes}
        for c in graph.channels:
            if c.src_pe != c.dst_pe:
                preds[c.dst_pe].add(c.src_pe)
        for n in self._order:
            depth[n] = 1 + max((depth[p] for p in preds[n]), default=-1)
        self.waves: list[list[str]] = []
        for n in self._order:
            while len(self.waves) <= depth[n]:
                self.waves.append([])
            self.waves[depth[n]].append(n)
        self._chan_by_src: dict[str, list] = {n: [] for n in graph.pes}
        for c in graph.channels:
            self._chan_by_src[c.src_pe].append(c)
        self.programs: list[_WaveProgram] = [self._compile_wave(w) for w in self.waves]
        # the route program (verifier) and the bridged program (first
        # partitioned run) are compiled on first use; so is the spmd lowering,
        # which needs n_nodes ranks that the other modes must not require
        self._route_prog = None
        self._bridge_prog: Optional[BridgedProgram] = None
        self._spmd_mesh = None
        self._spmd_fn = None
        self._hop_cache: dict[tuple[int, int], int] = {}   # (src, dst) -> hops
        # static verification of everything just compiled (`analysis`)
        self.verification = []
        if verify != "off":
            from ..analysis.diagnostics import VerificationError, errors, format_diagnostics
            from ..analysis.lint import verify_executor

            self.verification = verify_executor(self)
            if errors(self.verification) and verify == "strict":
                raise VerificationError(self.verification)
            if self.verification and verify == "warn":
                import warnings

                warnings.warn(format_diagnostics(self.verification), stacklevel=2)

    def _ensure_bridge(self) -> BridgedProgram:
        """Compile the partitioned (bridged) program once per executor."""
        if self._bridge_prog is None:
            if self._route_prog is None:
                self._route_prog = compile_routes(self.topo)
            self._bridge_prog = compile_bridges(
                self._route_prog, self.plan,
                BridgeConfig(serdes=self.plan.serdes_cfg,
                             fifo_depth=self.cfg.bridge_fifo_depth))
        return self._bridge_prog

    # -- spmd lowering -------------------------------------------------------
    def _ensure_spmd(self) -> None:
        """Build the NoC mesh and this rank's route function once per
        executor: the compiled route program over `partition.mesh_for_topology`,
        or under a plan the bridged program over `partition.mesh_for_partition`
        (`interchip.run_bridged_program`)."""
        if self._spmd_fn is not None:
            return
        if self._route_prog is None:
            self._route_prog = compile_routes(self.topo)
        prog = self._route_prog
        if self.plan is not None:
            bprog = self._ensure_bridge()
            mesh = mesh_for_partition(self.topo, self.plan)

            def route(row):
                return run_bridged_program(row, bprog, mesh, mesh.axis_names)
        else:
            mesh = mesh_for_topology(self.topo)

            def route(row):
                return run_route_program(row, prog, mesh)
        self._spmd_mesh, self._spmd_fn = mesh, route

    def _route_spmd(self, cube: torch.Tensor, B: Optional[int]):
        """Move one wave's message cube over the device mesh: this rank sends
        its node's row through the route program, and the delivered rows are
        gathered from every node.

        cube: (n, n, buf) or (B, n, n, buf).  Same (delivered, stats) contract
        as :func:`simulate_schedule` — the batch rides along as payload bytes,
        so rounds are physical while link_bytes scale with B.  Returns
        ``(delivered, ScheduleStats, BridgeStats | None)``; the bridge stats
        are analytic (`interchip.bridge_program_stats`), which the simulator
        matches exactly."""
        self._ensure_spmd()
        mesh = self._spmd_mesh
        rows = cube if B is None else torch.movedim(cube, 0, 2)     # (n, n, [B,] buf)
        if mesh.node >= 0:
            got = self._spmd_fn(rows[mesh.node].contiguous())
        else:
            got = torch.zeros_like(rows[0])
        delivered = mesh.gather_nodes(got)                         # (n_dst, n_src, ...)
        if B is not None:
            delivered = torch.movedim(delivered, 2, 0).contiguous()
        bstats = None
        if self.plan is not None:
            bstats = bridge_program_stats(self._bridge_prog, _nbytes(cube), tracer=self.tracer)
        return delivered, route_program_stats(self._route_prog, _nbytes(cube)), bstats

    def _switch_cfg(self) -> SwitchConfig:
        """NoCConfig knobs → the buffered transport's SwitchConfig."""
        return SwitchConfig(buffer_depth=self.cfg.switch_buffer_depth,
                            n_vcs=self.cfg.switch_vcs,
                            flit_bytes=self.cfg.flit_wire_bytes)

    # -- telemetry -------------------------------------------------------------
    def _hops(self, s: int, d: int) -> int:
        """Hop distance ``s -> d`` under dimension-ordered routing — the
        per-message ``hops`` the latency profiler charges as the in-flight
        component (cached; the same for every transport)."""
        h = self._hop_cache.get((s, d))
        if h is None:
            h = len(dor_route(self.topo, s, d, max(2, self.cfg.switch_vcs))[0]) - 1
            self._hop_cache[(s, d)] = h
        return h

    def _msg_args(self, s: int, d: int, nbytes: int, shape, dtype, n: int) -> dict:
        """Args of one ``msg`` event: the event-level mirror of the wave's
        static counters (payload, flits, cross-pod wire cost), scaled by ``n``."""
        cfg = self.cfg
        args = dict(src=s, dst=d, bytes=nbytes, flits=cfg.flits_for(nbytes), n=n,
                    hops=self._hops(s, d))
        pod_of = self.plan.pod_of_node if self.plan is not None else None
        if pod_of is not None and pod_of[s] != pod_of[d]:
            args["wire_bytes"] = qserdes.link_bytes_on_wire(shape, dtype, cfg.serdes)
            args["beats"] = cfg.serdes.lanes
        return args

    def _trace_msgs(self, tr: Tracer, prog: "_WaveProgram", scale: int, t0: int) -> None:
        """One ``msg`` event per compiled slot, which is what makes trace
        aggregation exact."""
        for slot in prog.slots:
            s, d = self.placement[slot.src_pe], self.placement[slot.dst_pe]
            tr.instant("msg", f"node {s}", ts=t0,
                       **self._msg_args(s, d, slot.nbytes, slot.shape, slot.dtype, scale))

    def _trace_rounds(self, tr: Tracer, t0: int, cube_nbytes: int) -> None:
        """Per-round ``round`` instants and per-link ``link`` load counters for
        the schedule transports, from the compiled route program: each
        `interchip._walk_rounds` traversal moves ``cube_nbytes // den``,
        summing to exactly what the simulators count."""
        if self._route_prog is None:
            self._route_prog = compile_routes(self.topo)
        for r, (den, pairs) in enumerate(_walk_rounds(self._route_prog)):
            per = cube_nbytes // den
            agg: dict[tuple[int, int], int] = {}
            for p in pairs:
                agg[p] = agg.get(p, 0) + per
            tr.instant("round", "noc", ts=t0 + r, bytes=per * len(pairs), links=len(agg))
            for (s, d), b in agg.items():
                tr.counter("link", f"link {s}->{d}", b, ts=t0 + r)

    @staticmethod
    def _trace_wave(tr: Tracer, t0: int, dur_route: int, wave: int, msgs: int,
                    nbytes: int, mode: str) -> None:
        """The wave's scatter/route/gather spans and the wave span itself;
        the clock moves to the wave's end."""
        tr.span("scatter", "engine", t0, 1, msgs=msgs, bytes=nbytes)
        tr.span("route", "engine", t0 + 1, max(dur_route, 1), mode=mode)
        tr.span("gather", "engine", t0 + 1 + dur_route, 1)
        tr.span("wave", "noc", t0, dur_route + 2, wave=wave, msgs=msgs)
        tr.clock = t0 + dur_route + 2

    @staticmethod
    def _trace_empty_wave(tr: Tracer, wave: int) -> None:
        """A message-free wave: a 2-tick scatter+gather barrier."""
        tr.span("wave", "noc", tr.clock, 2, wave=wave, msgs=0)
        tr.clock += 2

    def _publish(self, stats: NoCStats, mode: str) -> None:
        reg = get_registry()
        if reg is not None:
            reg.record_noc_stats(stats, mode=mode, topology=type(self.topo).__name__)

    # -- compile -------------------------------------------------------------
    def _compile_wave(self, wave: list[str]) -> _WaveProgram:
        g, cfg = self.graph, self.cfg
        n = self.topo.n_nodes
        pod_of = self.plan.pod_of_node if self.plan is not None else None
        slots: list[_MsgSlot] = []
        pair_off: dict[tuple[int, int], int] = {}
        static = NoCStats()
        seg = 0
        placed: list[tuple[int, int, int]] = []   # (src_node, dst_node, pair_offset)
        for name in wave:
            for c in self._chan_by_src[name]:
                port = g.pes[c.src_pe].out_port(c.src_port)
                nbytes = port.nbytes
                s, d = self.placement[c.src_pe], self.placement[c.dst_pe]
                off = pair_off.get((s, d), 0)
                pair_off[(s, d)] = off + cfg.flit_framed_bytes(nbytes)  # flit padding
                slots.append(_MsgSlot(c.src_pe, c.src_port, c.dst_pe, c.dst_port,
                                      tuple(port.shape), torch_dtype(port.dtype),
                                      nbytes, seg, seg + nbytes))
                placed.append((s, d, off))
                seg += nbytes
                static.payload_bytes += nbytes
                static.flits += cfg.flits_for(nbytes)
                if pod_of is not None and pod_of[s] != pod_of[d]:
                    static.cross_pod_msgs += 1
                    static.cross_pod_wire_bytes += qserdes.link_bytes_on_wire(
                        tuple(port.shape), port.dtype, cfg.serdes)
                    static.cross_pod_beats += cfg.serdes.lanes
        buf_bytes = max(pair_off.values(), default=0)
        pack, gather = [], []
        for slot, (s, d, off) in zip(slots, placed):
            span = np.arange(off, off + slot.nbytes, dtype=np.int64)
            pack.append((s * n + d) * buf_bytes + span)
            gather.append((d * n + s) * buf_bytes + span)   # delivered is (dst, src)

        def cat(xs):
            return np.concatenate(xs) if xs else np.zeros(0, np.int64)

        pack_host, gather_host = cat(pack), cat(gather)
        return _WaveProgram(tuple(slots), seg, buf_bytes,
                            torch.as_tensor(pack_host, device=self.device),
                            torch.as_tensor(gather_host, device=self.device), static,
                            tuple((s, d, nb) for (s, d), nb in sorted(pair_off.items())),
                            pack_host, gather_host)

    # -- firing --------------------------------------------------------------
    def _fire_batch(self, name: str, kwargs: dict[str, Any], B: int) -> Mapping[str, Any]:
        """Fire one PE on each of B stacked input sets and stack the outputs."""
        pe = self.graph.pes[name]
        items = [pe.fn(**{k: v[b] for k, v in kwargs.items()}) for b in range(B)]
        return {p.name: _stack([it[p.name] for it in items]) for p in pe.outputs}

    # -- packing -------------------------------------------------------------
    def _payload_segment(self, val: Any, slot: _MsgSlot, lead: tuple[int, ...]) -> torch.Tensor:
        """A message's bytes as a (*lead, nbytes) uint8 view, after checking
        it against its contract."""
        if (not isinstance(val, torch.Tensor) or tuple(val.shape) != lead + slot.shape
                or val.dtype != slot.dtype or val.device != self.device):
            got = (f"{tuple(val.shape)}/{val.dtype}/{val.device}"
                   if isinstance(val, torch.Tensor) else type(val).__name__)
            raise GraphError(
                f"message {slot.src_pe}.{slot.src_port} -> {slot.dst_pe}.{slot.dst_port}: "
                f"value {got} violates contract {lead + slot.shape}/{slot.dtype}/{self.device}")
        return val.contiguous().reshape(*lead, -1).view(torch.uint8)

    def _to_device(self, inputs: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in inputs.items()}

    @staticmethod
    def _check_mode(mode: str, modes: tuple[str, ...]) -> None:
        if mode not in modes:
            raise GraphError(f"unknown mode {mode!r}; use {'|'.join(map(repr, modes))}")

    # ------------------------------------------------------------------
    def run(self, inputs: Mapping[str, Any], mode: str = "sim") -> tuple[dict[str, Any], NoCStats]:
        self._check_mode(mode, ("direct", "sim", "spmd", "buffered", "sim_python"))
        inputs = self._to_device(inputs)
        if mode == "direct":
            return self.graph.run(inputs), NoCStats()
        if mode == "sim_python":
            return self._run_sim_python(inputs)
        mailbox = {tuple(k.split(".")): v for k, v in inputs.items()}
        return self._run_compiled(mailbox, B=None, transport=mode)

    def run_batch(self, inputs: Mapping[str, Any],
                  mode: str = "sim") -> tuple[dict[str, Any], NoCStats]:
        """Run B independent input sets at once; every input carries a leading
        batch axis ``(B, *port.shape)`` and so does every output.

        ``sim`` moves all B message sets through the topology in a single
        ``(B, n, n, bytes)`` :func:`simulate_schedule` call (``spmd``: one
        route of the batched rows; ``buffered``: the B sets ride inside the
        same wormhole packets).  Stats: waves/rounds
        are physical (counted once — the batch shares the schedule), while
        payload/flit/link/cross-pod byte counters scale with B."""
        self._check_mode(mode, ("direct", "sim", "spmd", "buffered"))
        if not inputs:
            raise GraphError("run_batch needs at least one input")
        inputs = self._to_device(inputs)
        B = int(next(iter(inputs.values())).shape[0])
        for k, v in inputs.items():
            if v.shape[0] != B:
                raise GraphError(f"input {k} batch axis {v.shape[0]} != {B}")
        if mode == "direct":
            items = [self.graph.run({k: v[b] for k, v in inputs.items()}) for b in range(B)]
            return {k: _stack([it[k] for it in items]) for k in items[0]}, NoCStats()
        mailbox = {tuple(k.split(".")): v for k, v in inputs.items()}
        return self._run_compiled(mailbox, B=B, transport=mode)

    def _run_compiled(self, mailbox: dict[tuple[str, str], Any], B: Optional[int],
                      transport: str = "sim") -> tuple[dict[str, Any], NoCStats]:
        """Execute the compiled flit program; ``B=None`` single-set, else a
        leading batch axis rides through every pack/route/unpack step.

        ``transport`` swaps how each wave's message cube moves: ``"sim"`` is
        the round-by-round schedule simulator (the bridged one under a plan),
        ``"spmd"`` the compiled route program over the device mesh,
        ``"buffered"`` the cycle-accurate wormhole switch.  Firing, framing
        and stats accumulation are shared, which is what makes the modes
        bit-identical on values by construction."""
        g, topo = self.graph, self.topo
        n = topo.n_nodes
        lead = () if B is None else (B,)
        scale = 1 if B is None else B
        stats = NoCStats()
        if transport == "spmd":
            self._ensure_spmd()     # fail fast if the mesh cannot be built
        tr = self.tracer
        if tr is not None:
            tr.instant("run", "noc", mode=transport, topology=type(topo).__name__,
                       n_nodes=n, batch=scale)
        for iw, (wave, prog) in enumerate(zip(self.waves, self.programs)):
            stats.waves += 1
            for name in wave:
                pe = g.pes[name]
                kwargs = {p.name: mailbox[(name, p.name)] for p in pe.inputs}
                results = (pe.fn(**kwargs) if B is None
                           else self._fire_batch(name, kwargs, B))
                for p in pe.outputs:
                    mailbox[(name, p.name)] = results[p.name]
            if not prog.slots:
                if tr is not None:
                    self._trace_empty_wave(tr, iw)
                continue
            payload = torch.cat([self._payload_segment(mailbox[(s.src_pe, s.src_port)], s, lead)
                                 for s in prog.slots], dim=-1)
            msgs_arr = torch.zeros(lead + (n * n * prog.buf_bytes,), dtype=torch.uint8,
                                   device=self.device)
            msgs_arr[..., prog.pack_idx] = payload
            cube = msgs_arr.reshape(lead + (n, n, prog.buf_bytes))
            t0 = 0
            if tr is not None:
                t0 = tr.clock
                self._trace_msgs(tr, prog, scale, t0)
                tr.clock = t0 + 1   # transport events start at the route phase
            bstats = None
            if transport == "spmd":
                delivered, sstats, bstats = self._route_spmd(cube, B)
                rounds, link_bytes = sstats.rounds, sstats.link_bytes
            elif transport == "buffered":
                delivered, swst = simulate_wormhole_cube(
                    topo, cube, self._switch_cfg(), pairs=prog.pairs, batched=B is not None,
                    tracer=tr)
                # mode-specific accounting: rounds are switch cycles (with
                # contention), link_bytes are flit-hops on the wormhole routes
                rounds = swst.cycles
                link_bytes = swst.link_flits * self.cfg.flit_wire_bytes
                stats._roll_switch(swst)
                if self.plan is not None:
                    # uncut routing + analytic bridge counters, as sim_python
                    bstats = bridge_program_stats(self._ensure_bridge(), _nbytes(cube),
                                                  tracer=tr)
            elif self.plan is not None:
                # partitioned: same schedule, pod-crossing hops serialized
                # through the bridge endpoints
                delivered, sstats, bstats = simulate_bridged_program(
                    self._ensure_bridge(), cube, batched=B is not None, tracer=tr)
                rounds, link_bytes = sstats.rounds, sstats.link_bytes
            else:
                delivered, sstats = simulate_schedule(topo, cube, batched=B is not None)
                rounds, link_bytes = sstats.rounds, sstats.link_bytes
            recv = delivered.reshape(lead + (-1,))[..., prog.gather_idx]
            for slot in prog.slots:
                seg = recv[..., slot.a:slot.b].clone()   # owns + aligns the bytes
                mailbox[(slot.dst_pe, slot.dst_port)] = (
                    seg.view(slot.dtype).reshape(lead + slot.shape))
            # prog.static only carries per-message counters, so it scales by B
            for f in dataclasses.fields(NoCStats):
                setattr(stats, f.name,
                        getattr(stats, f.name) + scale * getattr(prog.static, f.name))
            stats.rounds += rounds
            stats.link_bytes += link_bytes
            if bstats is not None:
                stats._roll_bridge(bstats)
            if tr is not None:
                dur_route = rounds + (bstats.stall_rounds if bstats is not None else 0)
                if transport in ("sim", "spmd"):
                    # buffered emitted its own per-cycle events; the schedule
                    # transports get the compiled program's exact rounds
                    self._trace_rounds(tr, t0 + 1, _nbytes(cube))
                self._trace_wave(tr, t0, dur_route, iw, len(prog.slots),
                                 scale * prog.payload_nbytes, transport)
        outs = {f"{pe}.{port.name}": mailbox[(pe, port.name)] for pe, port in g.graph_outputs()}
        self._publish(stats, transport)
        return outs, stats

    # ------------------------------------------------------------------
    def _run_sim_python(self, inputs: dict[str, torch.Tensor]) -> tuple[dict[str, Any], NoCStats]:
        """The seed per-message loop: every wave's framing is re-derived from
        the values, and each message is copied into and out of the cube on
        its own."""
        g, topo, cfg = self.graph, self.topo, self.cfg
        n = topo.n_nodes
        stats = NoCStats()
        mailbox = {tuple(k.split(".")): v for k, v in inputs.items()}
        pod_of = self.plan.pod_of_node if self.plan is not None else None
        tr = self.tracer
        if tr is not None:
            tr.instant("run", "noc", mode="sim_python", topology=type(topo).__name__,
                       n_nodes=n, batch=1)
        for iw, wave in enumerate(self.waves):
            stats.waves += 1
            # fire: (value, src_node, dst_node, dst_pe, dst_port) per message
            outbox: list[tuple[torch.Tensor, int, int, str, str]] = []
            for name in wave:
                pe = g.pes[name]
                results = pe.fn(**{p.name: mailbox[(name, p.name)] for p in pe.inputs})
                for p in pe.outputs:
                    mailbox[(name, p.name)] = results[p.name]
                for c in self._chan_by_src[name]:
                    outbox.append((results[c.src_port], self.placement[c.src_pe],
                                   self.placement[c.dst_pe], c.dst_pe, c.dst_port))
            if not outbox:
                if tr is not None:
                    self._trace_empty_wave(tr, iw)
                continue
            # frame messages into per-(src, dst) flit buffers and route them
            t0 = tr.clock if tr is not None else 0
            per_pair: dict[tuple[int, int], list] = {}
            for val, s, d, dpe, dport in outbox:
                per_pair.setdefault((s, d), []).append((val, dpe, dport))
                stats.payload_bytes += _nbytes(val)
                stats.flits += cfg.flits_for(_nbytes(val))
                if pod_of is not None and pod_of[s] != pod_of[d]:
                    stats.cross_pod_msgs += 1
                    stats.cross_pod_wire_bytes += qserdes.link_bytes_on_wire(
                        tuple(val.shape), val.dtype, cfg.serdes)
                    stats.cross_pod_beats += cfg.serdes.lanes
                if tr is not None:
                    tr.instant("msg", f"node {s}", ts=t0, **self._msg_args(
                        s, d, _nbytes(val), tuple(val.shape), val.dtype, 1))
            buf_bytes = max(sum(cfg.flit_framed_bytes(_nbytes(v)) for v, _, _ in msgs)
                            for msgs in per_pair.values())
            dur_route = 0
            if buf_bytes:
                msgs_arr = torch.zeros((n, n, buf_bytes), dtype=torch.uint8, device=self.device)
                for (s, d), msgs in per_pair.items():
                    off = 0
                    for v, _, _ in msgs:
                        raw = v.contiguous().reshape(-1).view(torch.uint8)
                        msgs_arr[s, d, off:off + raw.numel()] = raw
                        off += cfg.flit_framed_bytes(raw.numel())   # flit padding
                if tr is not None:
                    tr.clock = t0 + 1
                delivered, sstats = simulate_schedule(topo, msgs_arr)
                stats.rounds += sstats.rounds
                stats.link_bytes += sstats.link_bytes
                dur_route = sstats.rounds
                if pod_of is not None:
                    # the analytic bridge counters equal the bridged simulator's,
                    # so the seed loop stays comparable field for field
                    bstats = bridge_program_stats(self._ensure_bridge(), _nbytes(msgs_arr),
                                                  tracer=tr)
                    stats._roll_bridge(bstats)
                    dur_route += bstats.stall_rounds
                if tr is not None:
                    self._trace_rounds(tr, t0 + 1, _nbytes(msgs_arr))
                for (s, d), msgs in per_pair.items():
                    off = 0
                    for v, dpe, dport in msgs:
                        seg = delivered[d, s, off:off + _nbytes(v)].clone()
                        mailbox[(dpe, dport)] = seg.view(v.dtype).reshape(v.shape)
                        off += cfg.flit_framed_bytes(_nbytes(v))
            if tr is not None:
                self._trace_wave(tr, t0, dur_route, iw, len(outbox),
                                 sum(_nbytes(v) for v, *_ in outbox), "sim_python")
        outs = {f"{pe}.{port.name}": mailbox[(pe, port.name)] for pe, port in g.graph_outputs()}
        self._publish(stats, "sim_python")
        return outs, stats

    def run_iterative(self, inputs: Mapping[str, Any], feedback, n_iters: int,
                      mode: str = "sim") -> tuple[dict[str, Any], NoCStats]:
        state = dict(inputs)
        total = NoCStats()
        outs: dict[str, Any] = {}
        for _ in range(n_iters):
            outs, st = self.run(state, mode=mode)
            total.add(st)
            for src, dst in feedback:
                state[dst] = outs[src]
        return outs, total
