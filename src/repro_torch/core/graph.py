"""Phase-1 of the paper: message-passing application model.

An application is expressed as a graph of *processing elements* (PEs) — pure
functions fired when all their input messages have arrived — connected by
typed, fixed-shape *channels*.  This mirrors the paper's Fig. 3: the PE body is
the "Data processing" module; the framework supplies the "Data collector"
(argument FIFOs + fire-when-complete) and "Data distributor" (result fan-out)
semantics.

The graph is a *static* dataflow description: shapes and dtypes of every
message are known a priori ("Storage requirements of both input and output
memory modules should be known a priori", §II-B-1).  That staticness is what
lets the same graph be (a) executed directly with torch, (b) compiled onto a
topology routing schedule (core.routing), and (c) partitioned across pods.

Contracts keep numpy dtypes, exactly as in ``repro.core.graph``, so graphs and
their byte counts are identical in both packages; `Port.torch_dtype` names the
tensor dtype a message of the contract carries.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

# numpy contract dtype -> torch dtype of the tensors that carry it
_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.uint16): torch.uint16, np.dtype(np.int16): torch.int16,
    np.dtype(np.uint32): torch.uint32, np.dtype(np.int32): torch.int32,
    np.dtype(np.uint64): torch.uint64, np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy contract dtype."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"no torch dtype for contract dtype {np.dtype(dtype)}")


@dataclasses.dataclass(frozen=True)
class Port:
    """A typed endpoint of a PE.  shape/dtype are the message contract."""

    name: str
    shape: tuple[int, ...]
    dtype: Any = np.float32

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class PE:
    """A processing element: ``outputs = fn(**inputs)``.

    ``fn`` maps keyword args (one per input port, tensors of the declared
    shape) to a dict keyed by output-port name.  It must be pure; the
    framework owns all communication.
    """

    name: str
    fn: Callable[..., Mapping[str, Any]]
    inputs: tuple[Port, ...]
    outputs: tuple[Port, ...]

    def in_port(self, name: str) -> Port:
        for p in self.inputs:
            if p.name == name:
                return p
        raise KeyError(f"PE {self.name!r} has no input port {name!r}")

    def out_port(self, name: str) -> Port:
        for p in self.outputs:
            if p.name == name:
                return p
        raise KeyError(f"PE {self.name!r} has no output port {name!r}")


@dataclasses.dataclass(frozen=True)
class Channel:
    """A directed message channel ``src_pe.src_port -> dst_pe.dst_port``."""

    src_pe: str
    src_port: str
    dst_pe: str
    dst_port: str

    def key(self) -> tuple[str, str, str, str]:
        return (self.src_pe, self.src_port, self.dst_pe, self.dst_port)


class GraphError(ValueError):
    pass


class TaskGraph:
    """A static dataflow graph of PEs.

    Graph-level inputs are PE input ports nobody writes; graph-level outputs
    are PE output ports nobody reads (both may be overridden explicitly).
    """

    def __init__(self, name: str = "app"):
        self.name = name
        self.pes: dict[str, PE] = {}
        self.channels: list[Channel] = []

    # -- construction -------------------------------------------------------
    def add(self, pe: PE) -> PE:
        if pe.name in self.pes:
            raise GraphError(f"duplicate PE name {pe.name!r}")
        self.pes[pe.name] = pe
        return pe

    def connect(self, src: str, dst: str) -> Channel:
        """``connect("pe_a.out", "pe_b.x")``"""
        src_pe, src_port = src.split(".")
        dst_pe, dst_port = dst.split(".")
        sp = self.pes[src_pe].out_port(src_port)
        dp = self.pes[dst_pe].in_port(dst_port)
        if sp.shape != dp.shape or np.dtype(sp.dtype) != np.dtype(dp.dtype):
            raise GraphError(
                f"channel {src} -> {dst}: contract mismatch "
                f"{sp.shape}/{np.dtype(sp.dtype)} vs {dp.shape}/{np.dtype(dp.dtype)}"
            )
        ch = Channel(src_pe, src_port, dst_pe, dst_port)
        self.channels.append(ch)
        return ch

    # -- analysis -----------------------------------------------------------
    def validate(self) -> None:
        seen: set[tuple[str, str]] = set()
        for ch in self.channels:
            k = (ch.dst_pe, ch.dst_port)
            if k in seen:
                raise GraphError(f"input port {ch.dst_pe}.{ch.dst_port} written twice")
            seen.add(k)

    def graph_inputs(self) -> list[tuple[str, Port]]:
        fed = {(c.dst_pe, c.dst_port) for c in self.channels}
        out = []
        for pe in self.pes.values():
            for p in pe.inputs:
                if (pe.name, p.name) not in fed:
                    out.append((pe.name, p))
        return out

    def graph_outputs(self) -> list[tuple[str, Port]]:
        read = {(c.src_pe, c.src_port) for c in self.channels}
        out = []
        for pe in self.pes.values():
            for p in pe.outputs:
                if (pe.name, p.name) not in read:
                    out.append((pe.name, p))
        return out

    def firing_order(self) -> list[str]:
        """Topological order of PEs (data-flow firing schedule).

        Raises GraphError on cycles — iterative apps (LDPC) are expressed as a
        graph per iteration plus an outer ``run_iterative``.
        """
        self.validate()
        preds: dict[str, set[str]] = {n: set() for n in self.pes}
        succs: dict[str, set[str]] = {n: set() for n in self.pes}
        for c in self.channels:
            if c.src_pe != c.dst_pe:
                preds[c.dst_pe].add(c.src_pe)
                succs[c.src_pe].add(c.dst_pe)
        ready = sorted(n for n, p in preds.items() if not p)
        order: list[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in sorted(succs[n]):
                preds[s].discard(n)
                if not preds[s]:
                    ready.append(s)
        if len(order) != len(self.pes):
            cyc = sorted(set(self.pes) - set(order))
            raise GraphError(f"graph has a cycle through {cyc}")
        return order

    def traffic_bytes(self) -> dict[tuple[str, str], int]:
        """Bytes moved per (src_pe, dst_pe) pair — input to placement/roofline."""
        out: dict[tuple[str, str], int] = {}
        for c in self.channels:
            b = self.pes[c.src_pe].out_port(c.src_port).nbytes
            k = (c.src_pe, c.dst_pe)
            out[k] = out.get(k, 0) + b
        return out

    # -- direct (single-device) execution ------------------------------------
    def run(self, inputs: Mapping[str, Any]) -> dict[str, Any]:
        """Execute the dataflow directly (the pure-software oracle).

        ``inputs`` / result are keyed ``"pe.port"``.  This is the reference
        semantics every distributed execution mode must match.
        """
        order = self.firing_order()
        mailbox: dict[tuple[str, str], Any] = {}
        for k, v in inputs.items():
            pe_name, port = k.split(".")
            self.pes[pe_name].in_port(port)  # contract check
            mailbox[(pe_name, port)] = v
        by_src: dict[str, list[Channel]] = {n: [] for n in self.pes}
        for c in self.channels:
            by_src[c.src_pe].append(c)
        for name in order:
            pe = self.pes[name]
            kwargs = {}
            for p in pe.inputs:
                if (name, p.name) not in mailbox:
                    raise GraphError(f"PE {name!r} fired with missing input {p.name!r}")
                kwargs[p.name] = mailbox[(name, p.name)]
            results = pe.fn(**kwargs)
            missing = {p.name for p in pe.outputs} - set(results)
            if missing:
                raise GraphError(f"PE {name!r} did not produce outputs {sorted(missing)}")
            for p in pe.outputs:
                mailbox[(name, p.name)] = results[p.name]
            # deliver along outgoing channels (Data Distributor semantics)
            for c in by_src[name]:
                mailbox[(c.dst_pe, c.dst_port)] = mailbox[(name, c.src_port)]
        return {f"{pe}.{port.name}": mailbox[(pe, port.name)] for pe, port in self.graph_outputs()}

    def run_iterative(self, inputs: Mapping[str, Any], feedback: Sequence[tuple[str, str]],
                      n_iters: int) -> dict[str, Any]:
        """Run the graph ``n_iters`` times, feeding ``feedback`` pairs
        (``"pe.out" -> "pe.in"``) from one iteration into the next.
        Used for iterative message-passing apps (LDPC decoding)."""
        state = dict(inputs)
        outs: dict[str, Any] = {}
        for _ in range(n_iters):
            outs = self.run(state)
            for src, dst in feedback:
                state[dst] = outs[src]
        return outs

    def __repr__(self) -> str:
        return f"TaskGraph({self.name!r}, pes={len(self.pes)}, channels={len(self.channels)})"
