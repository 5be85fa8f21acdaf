"""Static delivery/conservation proofs over compiled routing artifacts (port
of ``repro.analysis.delivery``).

The compiled stack has three layers of value-independent routing structure,
each verified here without moving a byte:

* :func:`verify_route_program` — a `routing.RouteProgram` is an explicit
  hop-permutation composition.  We execute it *symbolically*: per line phase,
  holder arrays track whose buffer each axis node holds after every hop move,
  so each commit (``out[i, src_table[i]] = buf[i, i]``) can be checked against
  the true holder, each hop permutation checked to be a single-step neighbor
  rotation in its buffer's direction, and the committed ``(dst, src)`` pair
  set checked to cover the axis all-to-all **exactly once** (conservation:
  every message delivered, none duplicated, none fabricated).  A 2D program's
  factorized composition then delivers iff each phase does and the phase
  sizes tile the node count — which is also checked.

* :func:`verify_bridged_program` — an `interchip.BridgedProgram` must agree
  with an independent re-walk of its base program: every pod-crossing hop of
  every round must map to a `BridgeLink` whose endpoints/pods match
  ``pod_of_node``, intra hops must stay intra, and the per-pod `PodProgram`
  views (nodes, per-round hops, egress/ingress bridges) must be exact
  projections.  Any cut hop without a matching bridge would silently move
  bytes across chips without a serdes endpoint.

* :func:`verify_wave_layout` — the executor's per-wave scatter/gather index
  vectors, read from the host copies the executor keeps beside the device
  tensors (nothing is read back from the card).  Given the proven transpose
  semantics of the transport (``delivered[d, s] == msgs[s, d]``), the wave
  delivers every payload byte exactly once iff ``pack_idx`` entries are
  unique, land inside their ``(src, dst)`` buffer's framed extent, and
  ``gather_idx`` is the exact source/destination-swapped image of
  ``pack_idx`` byte for byte.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.routing import LinePhase, RouteProgram
from .diagnostics import Diagnostic, diag


def _verify_line_phase(phase: LinePhase, where: str) -> list[Diagnostic]:
    """Symbolic execution of one compiled line phase (holder arrays)."""
    m = phase.sched.size
    wrap = phase.sched.wrap
    diags: list[Diagnostic] = []
    # holders[b][i]: whose buffer node i holds in rotating buffer b (-1: none)
    holders = [list(range(m)), list(range(m))]
    committed: dict[tuple[int, int], int] = {(i, i): 1 for i in range(m)}
    for r, rnd in enumerate(phase.rounds):
        for k, mv in enumerate(rnd.moves):
            w = f"{where}.rounds[{r}].moves[{k}]"
            if mv.buf not in (0, 1):
                diags.append(diag("NOC003", f"buf={mv.buf} names no rotating "
                                            f"buffer (0=fwd, 1=bwd)", w))
                continue
            step = 1 if mv.buf == 0 else -1
            srcs = [s for s, _ in mv.perm]
            dsts = [d for _, d in mv.perm]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                diags.append(diag("NOC003", "hop permutation reuses an "
                                            "endpoint (not a permutation)", w))
                continue
            bad = [(s, d) for s, d in mv.perm
                   if not (0 <= s < m and 0 <= d < m)
                   or (d != (s + step) % m if wrap else d != s + step)]
            if bad:
                diags.append(diag(
                    "NOC003", f"non-neighbor hop pairs {bad[:4]} for a "
                              f"{step:+d} move on a size-{m} "
                              f"{'ring' if wrap else 'line'}", w))
                continue
            cur = holders[mv.buf]
            nh = [-1] * m
            for s, d in mv.perm:
                nh[d] = cur[s]
            holders[mv.buf] = nh
            if len(mv.src_table) != m:
                diags.append(diag("NOC003", f"src_table length "
                                            f"{len(mv.src_table)} != axis "
                                            f"size {m}", w))
                continue
            for i, src in enumerate(mv.src_table):
                if src < 0:
                    continue
                if src >= m:
                    diags.append(diag("NOC003", f"src_table[{i}]={src} out "
                                                f"of range", w))
                    continue
                if nh[i] != src:
                    diags.append(diag(
                        "NOC003", f"node {i} commits the message of source "
                                  f"{src} but holds the buffer of "
                                  f"{'nobody' if nh[i] < 0 else nh[i]}", w))
                committed[(i, src)] = committed.get((i, src), 0) + 1
    missing = [(i, j) for i in range(m) for j in range(m)
               if (i, j) not in committed]
    if missing:
        diags.append(diag("NOC003", f"{len(missing)} (dst, src) pairs are "
                                    f"never delivered (first few: "
                                    f"{missing[:4]})", where))
    dup = sorted(k for k, v in committed.items() if v > 1)
    if dup:
        diags.append(diag("NOC003", f"{len(dup)} (dst, src) pairs are "
                                    f"delivered more than once (first few: "
                                    f"{dup[:4]})", where))
    return diags


def verify_route_program(prog: RouteProgram) -> list[Diagnostic]:
    """Prove a compiled program realizes the all-to-all transpose exactly."""
    where = f"RouteProgram({prog.topo_name})"
    diags: list[Diagnostic] = []
    if prog.fused:
        return diags     # single lax.all_to_all: transpose by definition
    sizes = [p.sched.size for p in prog.phases]
    want = int(np.prod(sizes, dtype=np.int64))
    if want != prog.n_nodes:
        diags.append(diag("NOC003", f"phase sizes {sizes} tile {want} nodes, "
                                    f"program claims {prog.n_nodes}", where))
    if len(prog.phases) == 2:
        # phases run X then Y; axes are declared (noc_y, ry), (noc_x, rx)
        (_, ry), (_, rx) = prog.axes
        if (prog.phases[0].sched.size, prog.phases[1].sched.size) != (rx, ry):
            diags.append(diag("NOC003", f"phase sizes {sizes} disagree with "
                                        f"mesh axes rx={rx}, ry={ry}", where))
    for i, phase in enumerate(prog.phases):
        diags.extend(_verify_line_phase(phase, f"{where}.phases[{i}]"))
    return diags


def verify_bridged_program(bprog) -> list[Diagnostic]:
    """Check a BridgedProgram against an independent re-walk of its base
    program: cut coverage, bridge tables, and per-pod projections."""
    from ..core.interchip import _walk_rounds

    prog = bprog.prog
    diags = verify_route_program(prog)
    n = prog.n_nodes
    pod_of = bprog.pod_of_node
    where = f"BridgedProgram({prog.topo_name})"
    if len(pod_of) != n:
        diags.append(diag("NOC008", f"pod_of_node covers {len(pod_of)} "
                                    f"nodes, program has {n}", where))
        return diags
    # pod ids are labels compared only for equality; empty pods are legal
    bad_ids = sorted({p for p in pod_of if p < 0})
    if bad_ids:
        diags.append(diag("NOC008", f"negative pod ids {bad_ids} in "
                                    f"pod_of_node", where))
    seen_links: set[tuple[int, int]] = set()
    for i, b in enumerate(bprog.bridges):
        w = f"{where}.bridges[{i}]"
        if not (0 <= b.src < n and 0 <= b.dst < n):
            diags.append(diag("NOC004", f"bridge endpoints ({b.src}, "
                                        f"{b.dst}) out of range", w))
            continue
        if (pod_of[b.src], pod_of[b.dst]) != (b.src_pod, b.dst_pod):
            diags.append(diag("NOC004", f"bridge pods ({b.src_pod}, "
                                        f"{b.dst_pod}) disagree with "
                                        f"pod_of_node ({pod_of[b.src]}, "
                                        f"{pod_of[b.dst]})", w))
        elif b.src_pod == b.dst_pod:
            diags.append(diag("NOC004", f"bridge ({b.src}->{b.dst}) joins a "
                                        f"link that never crosses the cut", w))
        if (b.src, b.dst) in seen_links:
            diags.append(diag("NOC004", f"duplicate bridge for link "
                                        f"({b.src}->{b.dst})", w))
        seen_links.add((b.src, b.dst))
    walked = list(_walk_rounds(prog))
    if len(walked) != len(bprog.rounds):
        diags.append(diag("NOC004", f"{len(bprog.rounds)} compiled rounds, "
                                    f"base program walks {len(walked)}",
                          where))
        return diags
    for r, ((den, pairs), rnd) in enumerate(zip(walked, bprog.rounds)):
        w = f"{where}.rounds[{r}]"
        if rnd.den != den:
            diags.append(diag("NOC004", f"den={rnd.den}, re-walk says {den} "
                                        f"(per-traversal byte share wrong)",
                              w))
        want_intra = sorted(p for p in pairs if pod_of[p[0]] == pod_of[p[1]])
        if sorted(rnd.intra) != want_intra:
            diags.append(diag("NOC004", "intra-pod hop set disagrees with "
                                        "the re-walk", w))
        want_cross = sorted(p for p in pairs if pod_of[p[0]] != pod_of[p[1]])
        got_cross = []
        for bidx in rnd.cross:
            if not 0 <= bidx < len(bprog.bridges):
                diags.append(diag("NOC004", f"cross index {bidx} names no "
                                            f"bridge", w))
                continue
            b = bprog.bridges[bidx]
            got_cross.append((b.src, b.dst))
        if sorted(got_cross) != want_cross:
            missing = [p for p in want_cross if p not in got_cross]
            extra = [p for p in got_cross if p not in want_cross]
            diags.append(diag(
                "NOC004", f"cut hops without a matching BridgeLink: "
                          f"{missing[:4]}; bridged hops the schedule never "
                          f"drives: {extra[:4]}", w))
    for p, pod in enumerate(bprog.pods):
        w = f"{where}.pods[{p}]"
        want_nodes = tuple(i for i in range(n) if pod_of[i] == p)
        if pod.pod != p or pod.nodes != want_nodes:
            diags.append(diag("NOC004", f"pod view claims pod {pod.pod} "
                                        f"nodes {pod.nodes}, partition says "
                                        f"pod {p} nodes {want_nodes}", w))
            continue
        if len(pod.rounds) != len(bprog.rounds):
            diags.append(diag("NOC004", f"pod view has {len(pod.rounds)} "
                                        f"rounds, program {len(bprog.rounds)}",
                              w))
            continue
        for r, rnd in enumerate(bprog.rounds):
            want = tuple(pr for pr in rnd.intra if pod_of[pr[0]] == p)
            if pod.rounds[r] != want:
                diags.append(diag("NOC004", f"round {r} hops are not the "
                                            f"pod-{p} projection of the "
                                            f"program round", w))
        want_eg = tuple(i for i, b in enumerate(bprog.bridges)
                        if b.src_pod == p)
        want_in = tuple(i for i, b in enumerate(bprog.bridges)
                        if b.dst_pod == p)
        if pod.egress != want_eg or pod.ingress != want_in:
            diags.append(diag("NOC004", "egress/ingress bridge lists are "
                                        "not the partition's projections", w))
    return diags


def verify_wave_layout(prog, n: int, where: str,
                       flit_wire_bytes: Optional[int] = None) -> list[Diagnostic]:
    """Conservation proof for one compiled `_WaveProgram` layout.

    ``prog`` duck-types the executor's wave program: the host index vectors
    ``pack_host`` and ``gather_host``, ``payload_nbytes``, ``buf_bytes``,
    ``pairs``."""
    diags: list[Diagnostic] = []
    pack = np.asarray(prog.pack_host)
    gather = np.asarray(prog.gather_host)
    nb = prog.buf_bytes
    if pack.shape != gather.shape or pack.size != prog.payload_nbytes:
        diags.append(diag("NOC003", f"index vectors cover {pack.size}/"
                                    f"{gather.size} bytes, payload is "
                                    f"{prog.payload_nbytes}", where))
        return diags
    if pack.size == 0:
        return diags
    if pack.min() < 0 or pack.max() >= n * n * nb:
        diags.append(diag("NOC003", "pack_idx leaves the message cube",
                          where))
        return diags
    if np.unique(pack).size != pack.size:
        diags.append(diag("NOC003", "pack_idx scatters two payload bytes to "
                                    "one cube byte (messages overlap)",
                          where))
    pair, off = np.divmod(pack, nb)
    s, d = np.divmod(pair, n)
    want_gather = (d * n + s) * nb + off
    if not np.array_equal(gather, want_gather):
        k = int(np.argmax(gather != want_gather))
        diags.append(diag(
            "NOC003", f"gather_idx[{k}] reads cube byte {int(gather[k])} "
                      f"but the transpose of pack_idx[{k}] is "
                      f"{int(want_gather[k])} — a byte delivered to the "
                      f"wrong (src, dst) slot", where))
    extent = np.zeros(n * n, np.int64)
    for ps, pd, pnb in prog.pairs:
        extent[ps * n + pd] = pnb
    over = off >= extent[pair]
    if over.any():
        k = int(np.argmax(over))
        diags.append(diag(
            "NOC003", f"payload byte {k} lands at offset {int(off[k])} of "
                      f"pair ({int(s[k])}, {int(d[k])}) past its framed "
                      f"extent {int(extent[int(pair[k])])}", where))
    if flit_wire_bytes is not None:
        ragged = [(ps, pd, pnb) for ps, pd, pnb in prog.pairs
                  if pnb % flit_wire_bytes]
        if ragged:
            diags.append(diag(
                "NOC003", f"pair extents not whole flits of "
                          f"{flit_wire_bytes}B: {ragged[:4]}", where))
    return diags
