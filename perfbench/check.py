"""The comparison that decides ``correct``.

While the window runs, `Sample` keeps ``check.batches`` (the cell's file) of
its finished batches, drawn from the seed: their served tokens and the
logits that the program's ``transformer.prefill`` and ``decode_step``
returned with them (`probes.Capture`).  Once the window has closed, the
harness draws those batches' inputs again from the seed and runs the plain
float32 reference of the configuration's family once over each request's
prompt and served tokens.  The numbers it can compare, each against the
cell's limit (``limits`` of the cell's file; a cell compares those that
separate its program from its control):

* ``token_mismatch``: served tokens that are not the first choice of the
  logits the program returned with them (exact, so limit 0);
* ``logit_err_median``, ``logit_err_mean``, ``logit_err_max``: at each
  served position the relative error of the program's logits against the
  reference's, ``|program - reference| / |reference - its mean over the
  vocabulary|`` (2-norms over the vocabulary), the median, the mean and the
  widest over the sample;
* ``mean_gap``, ``max_gap``: the gap by which a served token's reference
  logit lies below the reference's best at its position (0 where the
  program chose the reference's own best), the mean and the widest.

The control is the same reference in fp8 (`reference.common.linear`) put in
the program's place: its logits at the same positions, read the same way,
and the tokens it puts first, read by their gaps.
"""
from __future__ import annotations

import importlib

import numpy as np

from .traffic import substream


class Sample:
    """``k`` batches of a stream of unknown length, each equally likely,
    drawn from ``seed`` (reservoir sampling), so a run holds the logits of
    ``k`` batches and of the one being served, not of the whole window."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, substream(seed, 3)
        self.kept: dict[int, object] = {}
        self.seen = 0

    def offer(self, i: int, item) -> None:
        if len(self.kept) < self.k:
            self.kept[i] = item
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[i] = item
        self.seen += 1


def reference_module(cfg_file: dict):
    return importlib.import_module(f"perfbench.reference.{cfg_file['reference']}")


def gaps(ref_logits, chosen):
    """(B, G) gap of each chosen token below the reference's best."""
    import torch

    best = ref_logits.amax(-1)
    got = torch.gather(ref_logits, -1, chosen[..., None].long())[..., 0]
    return (best - got).clamp_min(0.0)


def logit_err(logits, ref_logits):
    """(B, G) relative error of ``logits`` against the reference's at each position."""
    centred = ref_logits - ref_logits.mean(-1, keepdim=True)
    return (logits.float() - ref_logits).norm(dim=-1) / centred.norm(dim=-1)


def _readings(gap, err, mismatch) -> dict:
    return {"gap": gap.cpu().numpy(), "err": err.cpu().numpy(), "mismatch": int(mismatch)}


def summarize(readings: list[dict]) -> dict:
    g = np.concatenate([r["gap"].reshape(-1) for r in readings]).astype(np.float64)
    e = np.concatenate([r["err"].reshape(-1) for r in readings]).astype(np.float64)
    return {"token_mismatch": sum(r["mismatch"] for r in readings),
            "logit_err_median": float(np.median(e)), "logit_err_mean": float(e.mean()),
            "logit_err_max": float(e.max()),
            "max_gap": float(g.max()), "mean_gap": float(g.mean()), "tokens": int(g.size),
            "gap_share": float((g > 0).mean())}


def compare(params, cfg_file, batches, served, logits, device, control=False):
    """Readings of ``batches`` (`traffic.Batch` list), with the (B, gen)
    ``served`` tokens and the program's ``logits`` (for each batch the list of
    (B, V) tensors it returned, one a served position) beside them, against
    the float32 reference; with ``control`` also the fp8 control's.  Returns
    (program readings, control readings or None), for `summarize`."""
    import torch

    from .reference.common import no_tf32

    no_tf32()
    ref = reference_module(cfg_file)
    prog, ctrl = [], []
    for b, out, lg in zip(batches, served, logits):
        prompts = torch.as_tensor(b.prompts, device=device)
        tok = torch.as_tensor(out, device=device).long()
        port = torch.stack(lg, 1)                    # (B, gen, V), as returned
        mismatch = (port.argmax(-1).to(device) != tok).sum().item()
        r = ref.logits(params, cfg_file, prompts, b.frames, tok, "f32")
        prog.append(_readings(gaps(r, tok), logit_err(port.to(device), r), mismatch))
        del port
        if control:
            c = ref.logits(params, cfg_file, prompts, b.frames, tok, "fp8")
            ctrl.append(_readings(gaps(r, c.argmax(-1)), logit_err(c, r), 0))
            del c
        del r
    return prog, (ctrl if control else None)


def judge(stats: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    compared = {k: {"value": stats[k], "limit": float(v)} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
