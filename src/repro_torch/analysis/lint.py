"""Config linter + whole-executor verification + the lint CLI (port of
``repro.analysis.lint``).

The linters turn misconfigurations that previously surfaced mid-simulation
(or not at all) into `Diagnostic` records with stable NOC0xx codes:

* :func:`lint_graph`       — PE-graph contract violations (NOC009);
* :func:`lint_placement`   — unknown PEs / out-of-range nodes (NOC007);
* :func:`lint_plan`        — pod-cut coverage, density, and channel
                             classification (NOC008);
* :func:`lint_noc_config`  — field validity (NOC012), serdes/flit framing
                             mismatches (NOC010), and — given a topology —
                             the channel-dependency deadlock proof (NOC001);
* :func:`lint_model_config`— MoE-over-NoC dispatch degradations (NOC011);
* :func:`verify_executor`  — everything above plus the delivery proofs and
                             capacity bounds for one `NoCExecutor`'s compiled
                             artifacts; this is what
                             ``NoCExecutor(verify="strict")`` runs.

CLI
---
``python -m repro_torch.analysis [apps] [configs] [benchmarks]
[--strict-warnings] [--device {cuda,cpu}]`` sweeps the three case-study app
defaults (graphs compiled onto their default topologies, verified end to
end), every architecture registered in the port's `configs`, and the
benchmark-table topology × traffic-pattern grid.  Errors exit 1 (warnings too
with ``--strict-warnings``).  ``apps`` builds executors, whose index vectors
live on ``--device`` (default ``cuda``; no GPU raises rather than falling
back to the CPU).
"""
from __future__ import annotations

import sys

from ..core.topology import TOPOLOGIES, Topology, make_topology
from .capacity import check_traffic, executor_bounds
from .cdg import check_deadlock_freedom
from .delivery import (verify_bridged_program, verify_route_program,
                       verify_wave_layout)
from .diagnostics import Diagnostic, diag, errors


def lint_graph(graph) -> list[Diagnostic]:
    """NOC009: contract violations in a `graph.TaskGraph`."""
    from ..core.graph import GraphError

    diags: list[Diagnostic] = []
    where = f"TaskGraph({graph.name})"
    try:
        graph.validate()
        graph.firing_order()
    except GraphError as e:
        diags.append(diag("NOC009", str(e), where))
    # channels appended without connect() bypass the contract check — redo it
    import numpy as np
    for c in graph.channels:
        w = f"{where}.channel({c.src_pe}.{c.src_port}->{c.dst_pe}.{c.dst_port})"
        try:
            sp = graph.pes[c.src_pe].out_port(c.src_port)
            dp = graph.pes[c.dst_pe].in_port(c.dst_port)
        except KeyError as e:
            diags.append(diag("NOC009", f"channel names a missing "
                                        f"endpoint: {e}", w))
            continue
        if sp.shape != dp.shape or np.dtype(sp.dtype) != np.dtype(dp.dtype):
            diags.append(diag(
                "NOC009", f"contract mismatch {sp.shape}/"
                          f"{np.dtype(sp.dtype)} vs {dp.shape}/"
                          f"{np.dtype(dp.dtype)}", w))
    return diags


def lint_placement(graph, topo: Topology, placement) -> list[Diagnostic]:
    """NOC007: every PE on a real node, every placed name a real PE."""
    diags: list[Diagnostic] = []
    n = topo.n_nodes
    for pe, node in placement.items():
        w = f"placement[{pe!r}]"
        if pe not in graph.pes:
            diags.append(diag("NOC007", "placement names a PE the graph "
                                        "does not have", w))
        if not 0 <= node < n:
            diags.append(diag("NOC007", f"node {node} outside the {n}-node "
                                        f"{topo.name}", w))
    missing = sorted(set(graph.pes) - set(placement))
    if missing:
        diags.append(diag("NOC007", f"PEs with no node assigned: "
                                    f"{missing[:6]}", "placement"))
    return diags


def lint_plan(graph, topo: Topology, plan) -> list[Diagnostic]:
    """NOC008: pod-cut coverage, pod-id validity, and channel classification."""
    diags = lint_placement(graph, topo, plan.placement)
    n = topo.n_nodes
    pod_of = tuple(plan.pod_of_node)
    where = "PartitionPlan"
    if len(pod_of) != n:
        diags.append(diag("NOC008", f"pod_of_node covers {len(pod_of)} "
                                    f"nodes, topology has {n}", where))
        return diags
    # pod ids are labels compared only for equality — a cut that leaves a pod
    # empty (all nodes on one side) is legal; only negative ids are malformed
    bad = sorted({p for p in pod_of if p < 0})
    if bad:
        diags.append(diag("NOC008", f"negative pod ids {bad} in pod_of_node",
                          where))
    if errors(diags):
        return diags
    want_intra, want_cross = [], []
    for c in graph.channels:
        same = pod_of[plan.placement[c.src_pe]] == pod_of[plan.placement[c.dst_pe]]
        (want_intra if same else want_cross).append(c.key())
    if sorted(c.key() for c in plan.intra) != sorted(want_intra) or \
            sorted(c.key() for c in plan.cross) != sorted(want_cross):
        diags.append(diag(
            "NOC008", "intra/cross channel classification disagrees with "
                      "placement × pod_of_node — a cut channel would run "
                      "without serdes endpoints (or vice versa)", where))
    return diags


def lint_noc_config(cfg, topo: Topology = None) -> list[Diagnostic]:
    """NOC012/NOC010 for a `noc.NoCConfig`; NOC001 proof given a topology."""
    diags: list[Diagnostic] = []
    for f in ("flit_data_width", "flit_buffer_depth", "bridge_fifo_depth",
              "switch_buffer_depth", "switch_vcs"):
        v = getattr(cfg, f)
        if v < 1:
            diags.append(diag("NOC012", f"{f}={v} must be >= 1",
                              f"NoCConfig.{f}"))
    if cfg.flit_data_width % 8:
        diags.append(diag(
            "NOC010", f"flit_data_width={cfg.flit_data_width} is not "
                      f"byte-aligned: every flit pads to "
                      f"{cfg.flit_wire_bytes}B of storage/wire",
            "NoCConfig.flit_data_width"))
    beat = cfg.serdes.beat_bytes
    fw = cfg.flit_wire_bytes
    if fw % beat and beat % fw:
        diags.append(diag(
            "NOC010", f"flit word ({fw}B) and serdes beat ({beat}B) do not "
                      f"tile each other: every pod crossing re-pads its "
                      f"frames", "NoCConfig.serdes.wire_bits"))
    if topo is not None and not errors(diags):
        diags.extend(check_deadlock_freedom(topo, cfg.switch_vcs,
                                            "NoCConfig.switch_vcs"))
    return diags


def lint_model_config(mc, n_ranks: int = None) -> list[Diagnostic]:
    """NOC011: MoE-over-NoC dispatch degradations in a `configs.ModelConfig`."""
    diags: list[Diagnostic] = []
    where = f"ModelConfig({mc.name})"
    has_moe = any("moe" in layer for layer in mc.pattern)
    if not has_moe:
        return diags
    if mc.n_experts < 1:
        diags.append(diag("NOC011", "pattern has moe layers but "
                                    "n_experts=0", f"{where}.n_experts"))
        return diags
    if mc.top_k < 1 or mc.top_k > mc.n_experts:
        diags.append(diag("NOC011", f"top_k={mc.top_k} outside "
                                    f"1..n_experts={mc.n_experts}",
                          f"{where}.top_k"))
    if mc.moe_impl == "noc" and mc.moe_topology not in TOPOLOGIES:
        diags.append(diag("NOC011", f"moe_topology={mc.moe_topology!r} is "
                                    f"not a known topology "
                                    f"({sorted(TOPOLOGIES)})",
                          f"{where}.moe_topology"))
    if n_ranks and mc.n_experts % n_ranks:
        diags.append(diag(
            "NOC011", f"n_experts={mc.n_experts} not divisible by "
                      f"{n_ranks} NoC ranks: dispatch falls back to the "
                      f"dense reference path (no NoC routing, no flit "
                      f"accounting)", f"{where}.n_experts"))
    return diags


def verify_executor(ex) -> list[Diagnostic]:
    """Full static verification of one `NoCExecutor`'s compiled artifacts.

    Composes the config/graph/placement linters, the delivery proofs over
    the compiled route (and bridged) programs and per-wave scatter/gather
    layouts, and the capacity bounds.  This is the body of
    ``NoCExecutor(verify=...)``."""
    from ..core.routing import compile_routes

    diags = lint_graph(ex.graph)
    diags.extend(lint_placement(ex.graph, ex.topo, ex.placement))
    diags.extend(lint_noc_config(ex.cfg, ex.topo))
    n = ex.topo.n_nodes
    for w, prog in enumerate(ex.programs):
        diags.extend(verify_wave_layout(prog, n, f"NoCExecutor.programs[{w}]",
                                        ex.cfg.flit_wire_bytes))
    if ex._route_prog is None:
        ex._route_prog = compile_routes(ex.topo)
    diags.extend(verify_route_program(ex._route_prog))
    if ex.plan is not None:
        diags.extend(lint_plan(ex.graph, ex.topo, ex.plan))
        if not errors(diags):
            try:
                diags.extend(verify_bridged_program(ex._ensure_bridge()))
            except ValueError as e:
                diags.append(diag("NOC008", f"bridge compilation failed: "
                                            f"{e}", "PartitionPlan"))
    if not errors(diags):
        diags.extend(executor_bounds(ex).diagnostics)
    return diags


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.analysis [apps] [configs] [benchmarks]
# ---------------------------------------------------------------------------

def _lint_apps(device="cuda") -> list[tuple[str, list[Diagnostic]]]:
    """Verify the three case-study apps' default compiled executors."""
    import numpy as np

    from ..apps import bmvm, ldpc, particle_filter as pf
    from ..core.noc import NoCExecutor
    from ..core.partition import place_round_robin

    out = []
    rng = np.random.default_rng(0)

    g, _ = ldpc.build_ldpc_graph(ldpc.fano_plane_H())
    topo = make_topology("mesh", 16)
    ex = NoCExecutor(g, topo, verify="off", device=device)
    out.append(("ldpc/mesh16", verify_executor(ex)))

    bcfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    lut = bmvm.preprocess(rng.integers(0, 2, (bcfg.n, bcfg.n), np.uint8), bcfg,
                          device=device)
    g, _ = bmvm.build_bmvm_graph(lut, bcfg)
    topo = make_topology(bcfg.topology, 2 * bcfg.n_pe)
    ex = NoCExecutor(g, topo, verify="off", device=device)
    out.append((f"bmvm/{bcfg.topology}{topo.n_nodes}", verify_executor(ex)))

    pcfg = pf.PFConfig()
    g = pf.build_pf_graph(pcfg, 4)
    topo = make_topology("mesh", 8)
    ex = NoCExecutor(g, topo, placement=place_round_robin(g, topo),
                     verify="off", device=device)
    out.append(("particle_filter/mesh8", verify_executor(ex)))
    return out


def _lint_configs() -> list[tuple[str, list[Diagnostic]]]:
    """Lint every architecture registered in the port (full + smoke
    variants): the reference's ten archs."""
    from .. import configs

    out = []
    for name in configs.ALL_ARCHS:
        for smoke in (False, True):
            mc = configs.get_config(name, smoke=smoke)
            tag = f"configs/{name}" + ("/smoke" if smoke else "")
            out.append((tag, lint_model_config(mc, n_ranks=4)))
    return out


def _lint_benchmarks() -> list[tuple[str, list[Diagnostic]]]:
    """Lint the benchmark tables' topology × NoCConfig × traffic grid."""
    from ..core.noc import NoCConfig
    from ..core.traffic import PATTERNS, TrafficConfig

    out = []
    cfg = NoCConfig()
    combos = [("ring", 8), ("mesh", 16), ("torus", 16), ("fattree", 8)]
    for name, n in combos:
        topo = make_topology(name, n)
        out.append((f"bench/{name}{n}", lint_noc_config(cfg, topo)))
        for pattern in PATTERNS:
            tcfg = TrafficConfig(pattern=pattern, injection_rate=0.05,
                                 n_packets=8)
            out.append((f"bench/{name}{n}/{pattern}",
                        check_traffic(topo, tcfg, cfg.switch_vcs)))
    return out


_TARGETS = {"apps": _lint_apps, "configs": _lint_configs,
            "benchmarks": _lint_benchmarks}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    strict = "--strict-warnings" in argv
    argv = [a for a in argv if a != "--strict-warnings"]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv) or argv[i + 1] not in ("cuda", "cpu"):
            print("--device takes 'cuda' or 'cpu'")
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    targets = argv or sorted(_TARGETS)
    unknown = [t for t in targets if t not in _TARGETS]
    if unknown:
        print(f"unknown target(s) {unknown}; choose from {sorted(_TARGETS)}")
        return 2
    n_err = n_warn = 0
    for t in targets:
        found = _lint_apps(device) if t == "apps" else _TARGETS[t]()
        for where, diags in found:
            n_err += len(errors(diags))
            n_warn += len(diags) - len(errors(diags))
            status = ("ok" if not diags else
                      "FAIL" if errors(diags) else "warn")
            print(f"[{status:4s}] {where}")
            for d in diags:
                print(f"        {d}")
    print(f"lint: {n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err or (strict and n_warn) else 0


if __name__ == "__main__":
    sys.exit(main())
