"""Diagnostic plumbing for the static NoC verifier (port of
``repro.analysis.diagnostics``).

Every analysis in `analysis` reports findings as :class:`Diagnostic`
records with a **stable error code** (``NOC001``-style), a fixed severity, a
human message, and a source pointer (``where``) naming the config field /
artifact the finding is anchored to.  Codes are registered once in
:data:`CODES`; analyses construct diagnostics through :func:`diag` so the
code → severity mapping cannot drift between call sites.

``error`` diagnostics are violations of a proven property (a deadlockable
channel-dependency cycle, a mis-delivered compiled route, an invalid
placement): executing the artifact can wedge, drop, or corrupt traffic.
``warning`` diagnostics are predictions of degraded-but-correct behavior
(FIFO saturation, serdes framing padding, offered load past saturation).

:class:`VerificationError` is what ``NoCExecutor(verify="strict")`` raises —
a ``ValueError`` carrying the full diagnostic list so callers can match on
codes programmatically.
"""
from __future__ import annotations

import dataclasses

ERROR = "error"
WARNING = "warning"

#: code -> (severity, one-line description).  Append-only: codes are stable
#: identifiers that tests, CI logs, and downstream tooling match on.
CODES: dict[str, tuple[str, str]] = {
    "NOC001": (ERROR, "channel-dependency cycle: (topology, n_vcs) can "
                      "deadlock under wormhole switching"),
    "NOC002": (ERROR, "invalid switch parameter (buffer depth / VC count)"),
    "NOC003": (ERROR, "compiled route program violates exactly-once "
                      "delivery/conservation"),
    "NOC004": (ERROR, "bridged program cut mismatch (cut hop without a "
                      "BridgeLink, or inconsistent pod tables)"),
    "NOC005": (WARNING, "switch input FIFO predicted to saturate "
                        "(peak occupancy reaches buffer depth)"),
    "NOC006": (WARNING, "offered traffic load exceeds the analytic "
                        "saturation rate"),
    "NOC007": (ERROR, "invalid placement (unknown PE or node out of range)"),
    "NOC008": (ERROR, "invalid pod cut (coverage, pod ids, or channel "
                      "classification)"),
    "NOC009": (ERROR, "PE graph contract violation (shape/dtype mismatch, "
                      "double-written port, or dataflow cycle)"),
    "NOC010": (WARNING, "serdes framing mismatch (flit word and wire beat "
                        "sizes force padding on every crossing)"),
    "NOC011": (WARNING, "MoE dispatch config degrades (expert count not "
                        "divisible across ranks, or unusable knobs)"),
    "NOC012": (ERROR, "invalid NoCConfig field (non-positive width/depth/"
                      "VC count)"),
    "NOC013": (WARNING, "bridge FIFO predicted to back-pressure (peak "
                        "occupancy reaches fifo_depth)"),
    "NOC014": (ERROR, "traffic config unusable on this topology "
                      "(no destinations, or hotspot out of range)"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of a static analysis: code + severity + pointer + message."""

    code: str
    severity: str
    message: str
    where: str = ""

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code} {self.severity}{loc}: {self.message}"


def diag(code: str, message: str, where: str = "") -> Diagnostic:
    """Construct a Diagnostic with the registered severity for ``code``."""
    severity, _ = CODES[code]
    return Diagnostic(code, severity, message, where)


def errors(diags: list[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def format_diagnostics(diags: list[Diagnostic]) -> str:
    n_err = len(errors(diags))
    head = (f"{len(diags)} finding(s), {n_err} error(s):"
            if diags else "no findings")
    return "\n".join([head] + [f"  {d}" for d in diags])


class VerificationError(ValueError):
    """Static verification failed: one or more error-severity diagnostics.

    ``.diagnostics`` holds every finding (warnings included) so callers can
    match codes; ``str()`` renders the full report."""

    def __init__(self, diags: list[Diagnostic]):
        self.diagnostics = list(diags)
        super().__init__(format_diagnostics(self.diagnostics))
