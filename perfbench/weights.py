"""The model's weights, made on the device from the seed, in the dtype they
are served in.

The tree has the port's layout (``transformer.abstract_params``: the
program takes its params as that nested dict).  Every drawn leaf is a view
into one flat buffer filled by a few ``normal_`` calls of a generator on the
device, then scaled in place by the leaf's init kind (``fan_in``:
``scale / sqrt(fan in)``; ``embed``: ``scale``; ``small``: ``0.02 · scale``);
``ones`` and ``zeros`` leaves are filled.  The fan-in is that of the weight's
whole input (`fan_in`), not the port's rule for a rank-3 weight (its middle
dim: the 20 heads of Whisper's ``wq`` in place of its 1280 inputs), under
which attention's scores grow so large at full depth that float32 and
bfloat16 runs of the same model disagree on nearly every greedy token.  No
leaf has a float32 copy, so phi3.5-moe's 42 GB of bfloat16 weights fit
beside its caches.  The same seed gives the same weights; the reference
reads this same tree.
"""
from __future__ import annotations

import math

from .traffic import torch_seed

CHUNK = 2 ** 30          # elements a normal_ call fills
STACKING = ("layers", "experts")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def fan_in(spec) -> int:
    """The number of inputs each output of a weight sums over: its dims but
    the stacking ones (``layers``, ``experts``), all but the last where the
    output is ``embed`` (``wo`` (heads, head_dim, embed): H · D), else the
    first (``wq`` (embed, heads, head_dim): d)."""
    dims = [n for n, a in zip(spec.shape, spec.axes) if a not in STACKING]
    axes = [a for a in spec.axes if a not in STACKING]
    if len(dims) < 2:
        return max(dims[0], 1) if dims else 1
    return math.prod(dims[:-1]) if axes[-1] == "embed" else dims[0]


def _std(spec) -> float:
    if spec.init == "embed":
        return spec.scale
    if spec.init == "small":
        return 0.02 * spec.scale
    return spec.scale / math.sqrt(fan_in(spec))


def make_params(spec_tree, dtype, seed: int, device):
    """The params of ``spec_tree`` (`ParamSpec` leaves) as ``dtype`` tensors
    on ``device``, drawn from ``seed``."""
    import torch

    leaves = list(_leaves(spec_tree))
    drawn = [(p, s) for p, s in leaves if s.init not in ("ones", "zeros")]
    total = sum(math.prod(s.shape) for _, s in drawn)
    flat = torch.empty(total, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 0))
    for lo in range(0, total, CHUNK):
        flat[lo:lo + CHUNK].normal_(generator=g)
    out, off = {}, 0
    for path, spec in leaves:
        if spec.init == "ones":
            t = torch.ones(spec.shape, dtype=dtype, device=device)
        elif spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dtype, device=device)
        else:
            n = math.prod(spec.shape)
            t = flat[off:off + n].view(spec.shape).mul_(_std(spec))
            off += n
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out
