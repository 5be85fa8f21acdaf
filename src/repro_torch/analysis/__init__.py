"""Static verification of compiled NoC artifacts — no flit is ever moved
(port of ``repro.analysis``; it reads host data only).

Everything the compilation pipeline emits (`routing.RouteProgram` line
schedules, `noc.NoCExecutor` wave layouts, `interchip.BridgedProgram` pod
projections, `switch.SwitchConfig`/`noc.NoCConfig` parameter sets) is checked
*before* execution:

* `cdg` — Dally–Seitz channel-dependency deadlock proofs over the switch's
  actual routing function, replacing the hand-written VC guard;
* `delivery` — exactly-once delivery/conservation proofs for compiled route
  programs, bridged pod projections, and wave scatter/gather layouts;
* `capacity` — exact flit/byte accounting plus sound peak-occupancy bounds
  against the simulators' ``NoCStats`` high-water marks, and traffic
  saturation checks;
* `lint` — config linters and :func:`verify_executor`, the composition that
  backs ``NoCExecutor(verify="strict"|"warn"|"off")`` and the
  ``python -m repro_torch.analysis`` CLI.

Error-code reference
--------------------
Codes are stable, append-only identifiers (see `diagnostics.CODES`); the
severity is fixed per code.  ``error`` means executing the artifact can
wedge, drop, or corrupt traffic; ``warning`` predicts degraded-but-correct
behavior.

========  ========  ====================================================
Code      Severity  Meaning
========  ========  ====================================================
NOC001    error     channel-dependency cycle: (topology, n_vcs) can
                    deadlock under wormhole switching
NOC002    error     invalid switch parameter (buffer depth / VC count)
NOC003    error     compiled route program violates exactly-once
                    delivery/conservation
NOC004    error     bridged program cut mismatch (cut hop without a
                    BridgeLink, or inconsistent pod tables)
NOC005    warning   switch input FIFO predicted to saturate (peak
                    occupancy reaches buffer depth)
NOC006    warning   offered traffic load exceeds the analytic
                    saturation rate
NOC007    error     invalid placement (unknown PE or node out of range)
NOC008    error     invalid pod cut (coverage, pod ids, or channel
                    classification)
NOC009    error     PE graph contract violation (shape/dtype mismatch,
                    double-written port, or dataflow cycle)
NOC010    warning   serdes framing mismatch (flit word and wire beat
                    sizes force padding on every crossing)
NOC011    warning   MoE dispatch config degrades (expert count not
                    divisible across ranks, or unusable knobs)
NOC012    error     invalid NoCConfig field (non-positive
                    width/depth/VC count)
NOC013    warning   bridge FIFO predicted to back-pressure (peak
                    occupancy reaches fifo_depth)
NOC014    error     traffic config unusable on this topology (no
                    destinations, or hotspot out of range)
========  ========  ====================================================
"""
from .capacity import (CapacityReport, check_traffic, executor_bounds,
                       predicted_peaks, wave_channel_loads)
from .cdg import (build_cdg, check_deadlock_freedom, deadlock_cycle,
                  find_graph_cycle, find_wait_cycle, format_channel_cycle,
                  route_channels)
from .delivery import (verify_bridged_program, verify_route_program,
                       verify_wave_layout)
from .diagnostics import (CODES, ERROR, WARNING, Diagnostic,
                          VerificationError, diag, errors,
                          format_diagnostics)
from .lint import (lint_graph, lint_model_config, lint_noc_config,
                   lint_placement, lint_plan, verify_executor)

__all__ = [
    "CODES", "ERROR", "WARNING", "CapacityReport", "Diagnostic",
    "VerificationError", "build_cdg", "check_deadlock_freedom",
    "check_traffic", "deadlock_cycle", "diag", "errors", "executor_bounds",
    "find_graph_cycle", "find_wait_cycle", "format_channel_cycle",
    "format_diagnostics", "lint_graph", "lint_model_config",
    "lint_noc_config", "lint_placement", "lint_plan", "predicted_peaks",
    "route_channels", "verify_bridged_program", "verify_executor",
    "verify_route_program", "verify_wave_layout", "wave_channel_loads",
]
