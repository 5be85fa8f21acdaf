"""Tensor and data parallelism on a ``("data", "model")`` mesh: the cases of
tests/test_torch_tp_models.py, test_torch_tp_train.py and
test_torch_tp_cli.py (not collected itself).

Each file runs one gloo world of 4 single-threaded ranks
(`tests/torch_spmd_worlds.py`) on the meshes of :func:`meshes`: (1, 4) and
(2, 2) over all four ranks, and (1, 2) over ranks 0–1 and 2–3 side by side,
so every rank returns results of every mesh.  The rank-side functions here
import neither jax nor the reference; the reference-side ones run in the
test process (``ref_*``).
"""
from __future__ import annotations

import contextlib
import pickle

import numpy as np

MESHES = ((1, 2), (1, 4), (2, 2))
# (case, arch, config overrides): the part-2a archs at SMOKE, and llama3.2-1b
# with a vocab no model axis divides (the replicated-vocab branch) and with a
# padded one (``pad_vocab``: 250 classes in 256 columns)
MODEL_CASES = (
    ("llama3.2-1b", "llama3.2-1b", {}),
    ("gemma-7b", "gemma-7b", {}),
    ("whisper-large-v3", "whisper-large-v3", {}),
    ("internvl2-1b", "internvl2-1b", {}),
    ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b", {}),
    ("qwen3-moe-235b-a22b", "qwen3-moe-235b-a22b", {}),
    ("llama-vocab255", "llama3.2-1b", {"vocab": 255}),
    ("llama-vocab250", "llama3.2-1b", {"vocab": 250, "pad_vocab": True}),
)
# the vocab-parallel cross-entropy's cases: a vocab of 256, and one of 250
# padded to 256, whose last block holds the 6 padded classes
NLL_CASES = ("llama3.2-1b", "llama-vocab250")
TRAIN_ARCHS = ("llama3.2-1b", "qwen3-moe-235b-a22b")
TRAIN_MESHES = ((2, 2), (1, 4))
# the archs of the mla, mamba, mlstm and slstm mixers (ROADMAP item 8(e) part 2b)
PART_2B = ("minicpm3-4b", "jamba-v0.1-52b", "xlstm-350m")
# their model cases at SMOKE: both MLA paths, and xlstm with 2 heads, which a
# model axis of 4 does not divide where it divides mLSTM's inner channels
MIXER_CASES = (
    ("minicpm3-4b", "minicpm3-4b", {}),
    ("minicpm3-4b-absorb", "minicpm3-4b", {"mla_absorb": True}),
    ("jamba-v0.1-52b", "jamba-v0.1-52b", {}),
    ("xlstm-350m", "xlstm-350m", {}),
    ("xlstm-2heads", "xlstm-350m", {"n_heads": 2}),
)
CASES = {"models": MODEL_CASES, "mixers": MIXER_CASES}
# each mixer alone (a sub-layer with no ffn): (case, arch, mixer, overrides);
# xlstm at d_model 96 has an sLSTM FFN of 128 columns, which the model axes
# divide (85 at SMOKE's 64 does not)
MIXER_LAYERS = (
    ("mla", "minicpm3-4b", "mla", {}),
    ("mla-absorb", "minicpm3-4b", "mla", {"mla_absorb": True}),
    ("mamba", "jamba-v0.1-52b", "mamba", {}),
    ("mlstm", "xlstm-350m", "mlstm", {}),
    ("mlstm-2heads", "xlstm-350m", "mlstm", {"n_heads": 2}),
    ("slstm", "xlstm-350m", "slstm", {}),
    ("slstm-ff128", "xlstm-350m", "slstm", {"d_model": 96}),
)
LAYER_MESHES = ((1, 2), (1, 4))
# a leaf's gradient error is over at least this fraction of the whole
# gradient's norm: sLSTM's ``bi`` shifts every input gate of a head alike,
# which the stabilized recurrence cancels, so its gradient is zero in exact
# arithmetic and rounding alone in float32 (about 2e-9 of the whole's norm).
# A leaf's gradient off by a factor still shows down to 2e-8 of the whole's.
GRAD_FLOOR = 1e-3
B, S, PRE, GEN = 2, 12, 8, 4        # batch, sequence, prefill length, served tokens
LR, TOTAL, WARMUP, STEPS = 2e-3, 10, 5, 3


def meshes(rank):
    """Every mesh of :data:`MESHES` this rank is on (collective: every rank
    makes them all, in the same order)."""
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh

    halves = [coll.make_mesh((("data", 1), ("model", 2)), range(h, h + 2), axis_groups=True)
              for h in (0, 2)]
    return {(1, 2): halves[rank // 2], (1, 4): make_host_mesh(model=4),
            (2, 2): make_host_mesh(model=2)}


def inputs(cfg, seed=0):
    """Seeded tokens and labels (B, S), prompts (B, PRE), and frames or
    patches where the family reads them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "prompts": rng.integers(0, cfg.vocab, (B, PRE)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_frontend)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_frontend)).astype(np.float32)
    return out


def _prefix(cfg):
    return cfg.n_patches if cfg.family == "vlm" else 0


def nll_labels(cfg):
    """:func:`inputs`' labels with a label in each 64-column block of the
    vocab in every row (so in each rank's block of every model axis here),
    the last class, and two ignored (-1) positions."""
    lab = inputs(cfg)["labels"].copy()
    lab[:, :5] = [0, 64 + 1, 128 + 2, 192 + 3, cfg.vocab - 1]
    lab[0, 6] = lab[1, 9] = -1
    return lab


def _model_case(case):
    return next(c for c in MODEL_CASES if c[0] == case)


# ---------------------------------------------------------------------------
# the reference, in the test process
# ---------------------------------------------------------------------------

def ref_model(params, jcfg, inp):
    """The reference's unsharded results: forward logits, loss and metrics,
    prefill + teacher-forced decode logits (B, 1 + S - PRE, V), and greedy
    tokens (B, GEN) of the prompts with zero frames/patches (as both
    packages' serve_batch feed), each driven by hand, each entry point
    under ``jax.jit``."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    p = jax.tree.map(jnp.asarray, params)
    b = {k: jnp.asarray(v) for k, v in inp.items() if k != "prompts"}
    # jitted: the same values as op-by-op dispatch, compiled once a shape
    forward = jax.jit(lambda p, b: JT.forward(p, b, jcfg)[0])
    loss_fn = jax.jit(lambda p, b: JT.loss(p, b, jcfg))
    prefill = jax.jit(lambda p, b, c: JT.prefill(p, b, jcfg, c))
    decode = jax.jit(lambda p, b, c: JT.decode_step(p, b, jcfg, c))
    full = forward(p, b)
    loss, mets = loss_fn(p, b)
    cache = JT.init_cache(jcfg, B, _prefix(jcfg) + S)
    lg, cache = prefill(p, dict(b, tokens=b["tokens"][:, :PRE]), cache)
    steps = [np.asarray(lg[:, 0])]
    for t in range(PRE, S):
        lg, cache = decode(p, {"tokens": b["tokens"][:, t:t + 1]}, cache)
        steps.append(np.asarray(lg))
    g = {"tokens": jnp.asarray(inp["prompts"])}
    if jcfg.family == "encdec":
        g["frames"] = jnp.zeros((B, jcfg.enc_seq, jcfg.d_frontend), jcfg.cdtype)
    if jcfg.family == "vlm":
        g["patches"] = jnp.zeros((B, jcfg.n_patches, jcfg.d_frontend), jcfg.cdtype)
    cache = JT.init_cache(jcfg, B, _prefix(jcfg) + PRE + GEN)
    lg, cache = prefill(p, g, cache)
    tok = jnp.argmax(lg[:, -1], -1)
    toks = [np.asarray(tok)]
    for _ in range(GEN - 1):
        lg, cache = decode(p, {"tokens": tok[:, None]}, cache)
        tok = jnp.argmax(lg, -1)
        toks.append(np.asarray(tok))
    return {"forward": np.asarray(full), "loss": float(loss),
            "mets": {k: float(v) for k, v in mets.items()},
            "serve_logits": np.stack(steps, 1), "tokens": np.stack(toks, 1)}


def ref_nll_loss(params, jcfg, inp):
    """The reference's unsharded ``loss`` and nll on :func:`inputs` with
    :func:`nll_labels` (under ``jax.jit``)."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    p = jax.tree.map(jnp.asarray, params)
    b = {"tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(nll_labels(jcfg))}
    loss, mets = jax.jit(lambda p, b: JT.loss(p, b, jcfg))(p, b)
    return float(loss), float(mets["nll"])


def write_model_inputs(path, cases=MODEL_CASES) -> dict:
    """Each case's reference params (numpy, the reference's init) and inputs,
    pickled for the ranks; returns them."""
    import jax

    from repro.configs import get_config
    from repro.models import transformer as JT
    from repro.models.layers import init_params

    data = {}
    for case, arch, kw in cases:
        cfg = get_config(arch, smoke=True).replace(**kw)
        specs = JT.abstract_params(cfg)
        params = jax.tree.map(np.asarray, jax.jit(lambda k: init_params(specs, k))(
            jax.random.key(0)))
        data[case] = (params, inputs(cfg))
    with open(path, "wb") as fh:
        pickle.dump(data, fh)
    return data


# ---------------------------------------------------------------------------
# the port, in one rank of a gloo world of 4
# ---------------------------------------------------------------------------

def _torch_batch(inp, keys):
    import torch

    return {k: (torch.as_tensor(inp[k]).long() if inp[k].dtype.kind == "i"
                else torch.as_tensor(inp[k])) for k in keys if k in inp}


def model_results(rank, world, device, in_path, cases="models"):
    """Per case of ``CASES[cases]`` and mesh: forward, loss, prefill + decode
    and serve_batch on the rank's blocks (`shard_params`), with the rank's
    leaf and cache shapes; and the shard/gather round trip of every case's
    params.  With ``cases="mixers"`` also each mixer alone
    (:func:`mixer_layer_results`)."""
    import torch

    from repro_torch import convert
    from repro_torch._tree import flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.steps import shardings_for_params
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import gather_params, shard_params

    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    ms = meshes(rank)
    same, mine = {}, {}
    for case, arch, kw in CASES[cases]:
        cfg = get_config(arch, smoke=True).replace(**kw)
        params, inp = data[case]
        full = convert.model_params_to_torch(params, device)
        batch = _torch_batch(inp, ("tokens", "labels", "frames", "patches"))
        for shape, mesh in ms.items():
            specs = shardings_for_params(cfg, mesh)
            p = shard_params(full, specs, mesh)
            mine[("shapes", case, shape)] = {"/".join(map(str, k)): tuple(v.shape)
                                             for k, v in flatten(p)}
            back = gather_params(p, specs, mesh)
            same[("round-trip", case, shape)] = all(
                torch.equal(a, b) for (_, a), (_, b) in zip(flatten(back), flatten(full)))
            same[("fused", case, shape)] = _fused_blocks_ok(full, p, mesh)
            with set_mesh(mesh), torch.no_grad():
                logits, *_ = T.forward(p, batch, cfg)
                with vocab_gathers() as loss_gathers:
                    loss, mets = T.loss(p, batch, cfg)
                cache = T.init_cache(cfg, B, _prefix(cfg) + S, device=device)
                mine[("caches", case, shape)] = {f"{i}/{k}": tuple(v.shape)
                                                 for i, blk in cache["blocks"].items()
                                                 for k, v in blk.items() if k != "idx"}
                if "k" in cache["blocks"]["0"]:
                    mine[("cache", case, shape)] = tuple(cache["blocks"]["0"]["k"].shape)
                pre = dict(batch, tokens=batch["tokens"][:, :PRE])
                pre.pop("labels")
                with vocab_gathers() as prefill_gathers:
                    lg, cache = T.prefill(p, pre, cfg, cache)
                if cases == "models":
                    # the gathered forward's last position, into a fresh cache
                    old = T.forward(p, pre, cfg, T.init_cache(cfg, B, _prefix(cfg) + S,
                                                              device=device))[0][:, -1:]
                    same[("sharded", case, shape)] = {
                        "prefill_equal": torch.equal(lg, old), "shape": tuple(lg.shape),
                        "storage": lg.untyped_storage().nbytes() // lg.element_size(),
                        "loss_gathers": loss_gathers, "prefill_gathers": prefill_gathers}
                steps = [lg[:, 0]]
                for t in range(PRE, S):
                    lg, cache = T.decode_step(p, {"tokens": batch["tokens"][:, t:t + 1]}, cfg,
                                              cache)
                    steps.append(lg)
            toks = tserve.serve_batch(p, cfg, inp["prompts"], GEN, device=device, mesh=mesh)
            if case == "llama3.2-1b":
                try:
                    with set_mesh(mesh), torch.no_grad():
                        T.forward(full, batch, cfg)
                    same[("whole-tree", shape)] = None
                except ValueError as e:
                    same[("whole-tree", shape)] = str(e)
            same[(case, shape)] = {
                "forward": logits.numpy(), "loss": float(loss),
                "mets": {k: float(v) for k, v in mets.items()},
                "serve_logits": torch.stack(steps, 1).numpy(), "tokens": np.asarray(toks)}
    if cases == "mixers":
        same.update(mixer_layer_results(ms, device))
    if cases == "models":
        nll_same, nll_mine = nll_results(ms, device, data)
        same.update(nll_same)
        mine.update(nll_mine)
    return {"same": same, "rank": mine}


@contextlib.contextmanager
def vocab_gathers():
    """The shapes of the blocks that `core.collectives.gather_from` gathers
    along the last dim over an axis of more than one rank inside the block:
    the logits' vocab gathers (no other caller of the LM archs of
    :data:`MODEL_CASES` gathers along it)."""
    from repro_torch.core import collectives as coll

    calls, inner = [], coll.gather_from

    def spy(x, axis, dim):
        if dim == -1 and axis is not None and axis.size > 1:
            calls.append(tuple(x.shape))
        return inner(x, axis, dim)

    coll.gather_from = spy
    try:
        yield calls
    finally:
        coll.gather_from = inner


def nll_results(ms, device, data):
    """Each case of :data:`NLL_CASES` on each mesh with :func:`nll_labels`:
    ``loss`` and its nll (the same on every rank), and on the rank's rows
    the vocab-parallel cross-entropy of its block of the logits with the
    gradient of that block, against `cross_entropy` over the gathered
    logits and the gathered gradient's own block (each rank's own)."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.steps import shardings_for_params
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import (cross_entropy, shard_params,
                                           vocab_parallel_cross_entropy)

    same, mine = {}, {}
    for case in NLL_CASES:
        _, arch, kw = _model_case(case)
        cfg = get_config(arch, smoke=True).replace(**kw)
        params, inp = data[case]
        full = convert.model_params_to_torch(params, device)
        batch = _torch_batch(dict(inp, labels=nll_labels(cfg)), ("tokens", "labels"))
        for shape, mesh in ms.items():
            p = shard_params(full, shardings_for_params(cfg, mesh), mesh)
            with set_mesh(mesh):
                lay = T.layout(cfg, B)
                labels = lay.take_batch(batch["labels"])
                with torch.no_grad():
                    block = T._forward(p, batch, cfg, None, lay)[0]
                    loss, mets = T.loss(p, batch, cfg)
                block.requires_grad_()
                vp = vocab_parallel_cross_entropy(block, labels, lay.vocab)
                vp.backward()
                whole = coll.gather_blocks(block.detach(), lay.vocab, -1).requires_grad_()
                ce = cross_entropy(whole, labels)
                ce.backward()
                want = coll.own_block(whole.grad, lay.vocab, -1)
            same[("nll", case, shape)] = {"split": lay.vocab.size, "loss": float(loss),
                                          "nll": float(mets["nll"])}
            mine[("nll", case, shape)] = {
                "vp": float(vp.detach()), "ce": float(ce.detach()),
                "grad": float((block.grad - want).abs().max() / want.abs().max())}
    return same, mine


def _fused_blocks_ok(full, local, mesh) -> dict:
    """Per fused leaf (Mamba's ``in_proj``, mLSTM's ``up``: ``[x | z]`` side
    by side): whether the rank holds its model-axis block of x beside its
    block of z."""
    import torch

    from repro_torch._tree import flatten

    ax = mesh.axis("model")
    out = {}
    for (path, w), (_, mine) in zip(flatten(full), flatten(local)):
        if path[-1] in ("in_proj", "up") and path[-2] in ("mamba", "mlstm"):
            halves = w.chunk(2, -1)
            n = halves[0].shape[-1] // ax.size
            want = torch.cat([h[..., ax.coord * n:(ax.coord + 1) * n] for h in halves], -1)
            out["/".join(map(str, path))] = bool((mine == want).all())
    return out


def mixer_layer_results(ms, device) -> dict:
    """Each case of :data:`MIXER_LAYERS` (its sub-layer: the norm and the
    mixer, no ffn; the reference's init, seed 0; x seeded) on the meshes of
    :data:`LAYER_MESHES` against the same sub-layer on one rank: the output
    and, through the backward of sum(out · r), the gradient of x and the
    gathered gradient of every leaf, as ``||mesh - one|| / max(||one||,
    GRAD_FLOOR ||g||)`` (``g``: every leaf's one-rank gradient).  Also the
    rank's leaf shapes."""
    import torch

    from repro_torch._tree import flatten, leaves, unflatten
    from repro_torch.configs import get_config
    from repro_torch.core.partition import DEFAULT_RULES, mesh_shape
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import gather_params, init_params, param_pspecs, shard_params

    def run(cfg, mixer, p, x, r, lay):
        req = [t.detach().requires_grad_() for t in leaves(p)]
        x = x.detach().requires_grad_()
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        out, *_ = T._apply_sublayer(unflatten(p, req), x, cfg, mixer, "none", positions=pos,
                                    cache=None, enc_out=None, causal=True, lay=lay)
        (out * r).sum().backward()
        return out.detach(), x.grad, unflatten(p, [t.grad for t in req])

    res = {}
    for case, arch, mixer, kw in MIXER_LAYERS:
        cfg = get_config(arch, smoke=True).replace(**kw)
        specs = T._sublayer_specs(cfg, mixer, "none", False, torch.float32)
        whole = init_params(specs, torch.Generator().manual_seed(0), device)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn((B, S, cfg.d_model), generator=gen).to(device)
        r = torch.randn((B, S, cfg.d_model), generator=gen).to(device)
        out1, gx1, g1 = run(cfg, mixer, whole, x, r, T.Layout())
        floor = GRAD_FLOOR * float(torch.sqrt(sum(t.square().sum() for t in leaves(g1))))
        for shape in LAYER_MESHES:
            mesh = ms[shape]
            pspecs = param_pspecs(specs, DEFAULT_RULES, mesh.axis_names, mesh_shape(mesh))
            local = shard_params(whole, pspecs, mesh)
            with set_mesh(mesh):
                out, gx, g = run(cfg, mixer, local, x, r, T.layout(cfg, B, mesh))
                g = gather_params(g, pspecs, mesh)
            errs = {"out": float((out - out1).abs().max() / out1.abs().max()),
                    "x": float((gx - gx1).norm() / gx1.norm())}
            errs.update({"/".join(map(str, k)): _rel(a, b, floor)
                         for (k, a), (_, b) in zip(flatten(g), flatten(g1))})
            res[("layer", case, shape)] = (errs, {"/".join(map(str, k)): tuple(v.shape)
                                                  for k, v in flatten(local)})
    return res


def _one_rank_grads(params, batch, cfg):
    from repro_torch.core import collectives as coll
    from repro_torch.launch.steps import loss_and_grads

    with coll.use_mesh(None):
        return loss_and_grads(params, batch, cfg)


def _rel(a, b, floor=0.0) -> float:
    """||a - b|| / max(||b||, floor) (the absolute error when that is 0)."""
    nb = max(float(b.float().norm()), floor)
    return float((a - b).float().norm()) / nb if nb else float((a - b).float().norm())


def _train_case(arch, states, batches, mesh, device, floor=0.0):
    """``arch``'s SMOKE steps on ``mesh``, each from the reference's state
    before it: the metrics, and per leaf the relative error of the gathered
    gradient against the one-rank port's on the same state (`_rel`, over at
    least ``floor`` × the norm of every leaf's one-rank gradient)."""
    import torch

    from repro_torch import convert
    from repro_torch import optim as toptim
    from repro_torch._tree import flatten, leaves, unflatten
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.steps import loss_and_grads, make_train_step, state_shardings
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import gather_params, shard_params

    cfg = get_config(arch, smoke=True)
    sspecs = state_shardings(cfg, mesh)
    step = make_train_step(cfg, toptim.AdamWConfig(lr=LR), mesh=mesh, total_steps=TOTAL,
                           warmup=WARMUP)
    mets, gerr = [], []
    for s in range(STEPS):
        whole = {"params": convert.model_params_to_torch(states[s]["params"], device),
                 "opt": convert.opt_state_to_torch(states[s]["opt"], device)}
        batch = _torch_batch(batches[s], ("tokens", "labels"))
        _, _, g1 = _one_rank_grads(whole["params"], batch, cfg)
        least = floor * float(torch.sqrt(sum(t.square().sum() for t in leaves(g1))))
        local = shard_params(whole, sspecs, mesh)
        with set_mesh(mesh):
            _, _, g = loss_and_grads(local["params"], batch, cfg)
            bax = T.batch_axis(mesh, batch["tokens"].shape[0])
            if bax is not None:
                g = unflatten(g, [coll.pmean(x, bax) for x in leaves(g)])
            g = gather_params(g, sspecs["params"], mesh)
        gerr.append({"/".join(map(str, k)): _rel(a, b, least)
                     for (k, a), (_, b) in zip(flatten(g), flatten(g1))})
        _, m = step(local, batch)
        mets.append({k: float(v) for k, v in m.items()})
    return mets, gerr


def train_results(rank, world, device, in_path):
    """The SMOKE train steps of :data:`TRAIN_ARCHS` on :data:`TRAIN_MESHES`
    (:func:`_train_case`); then the part-2b archs from one seeded init: a
    step on a model axis of 2 (the (1, 2) mesh) and on a (2, 1) mesh (data
    parallelism alone) against the one-rank step."""
    import torch

    from repro_torch import optim as toptim
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.launch.steps import make_train_step, shardings_for_params
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params, shard_params

    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    ms = meshes(rank)
    same = {}
    for arch in TRAIN_ARCHS:
        states, batches = data[arch]
        for shape in TRAIN_MESHES:
            same[("train", arch, shape)] = _train_case(arch, states, batches, ms[shape], device)
    # (2, 1) meshes over ranks 0-1 and 2-3 (every rank makes both: a group is
    # collective)
    dp = [coll.make_mesh((("data", 2), ("model", 1)), range(h, h + 2), axis_groups=True)
          for h in (0, 2)][rank // 2]
    opt = toptim.AdamWConfig(lr=LR)
    for arch in PART_2B:
        cfg = get_config(arch, smoke=True)
        full = init_params(T.abstract_params(cfg), torch.Generator().manual_seed(0))
        batch = _torch_batch(data["part2b-batch"], ("tokens", "labels"))
        got = []
        for mesh in (ms[(1, 2)], dp, None):
            shard_on = mesh if mesh is not None else dp
            params = shard_params(full, shardings_for_params(cfg, shard_on), shard_on)
            step = make_train_step(cfg, opt, mesh=mesh, total_steps=TOTAL, warmup=WARMUP)
            _, m = step({"params": params, "opt": toptim.adamw_init(params)}, batch)
            got.append({k: float(v) for k, v in m.items()})
        same[("part2b", arch)] = got
    same.update(vocab_grad_results(ms, device))
    return {"same": same}


def vocab_grad_results(ms, device) -> dict:
    """The padded-vocab llama3.2-1b SMOKE (``llama-vocab250``; the port's
    init, seed 0) through ``loss`` on every mesh of :data:`MESHES` with
    :func:`nll_labels`: the vocab axis's size, the vocab gathers of the
    forward and backward (:func:`vocab_gathers`), the loss, the one-rank
    loss, and every leaf's gradient, gathered and averaged over the data
    axis, against the one-rank port's (`_rel`)."""
    import torch

    from repro_torch._tree import flatten, leaves, unflatten
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.steps import loss_and_grads, shardings_for_params
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import gather_params, init_params, shard_params

    _, arch, kw = _model_case("llama-vocab250")
    cfg = get_config(arch, smoke=True).replace(**kw)
    full = init_params(T.abstract_params(cfg), torch.Generator().manual_seed(0), device)
    batch = _torch_batch(dict(inputs(cfg), labels=nll_labels(cfg)), ("tokens", "labels"))
    loss1, _, g1 = _one_rank_grads(full, batch, cfg)
    res = {}
    for shape, mesh in ms.items():
        specs = shardings_for_params(cfg, mesh)
        with set_mesh(mesh):
            with vocab_gathers() as gathers:
                loss, _, g = loss_and_grads(shard_params(full, specs, mesh), batch, cfg)
            bax = T.batch_axis(mesh, B)
            if bax is not None:
                g = unflatten(g, [coll.pmean(x, bax) for x in leaves(g)])
            g = gather_params(g, specs, mesh)
            split = T.layout(cfg, B).vocab.size
        res[("vocab-grads", shape)] = (split, gathers, float(loss), float(loss1), {
            "/".join(map(str, k)): _rel(a, b) for (k, a), (_, b) in zip(flatten(g), flatten(g1))})
    return res


def mixer_train_results(rank, world, device, in_path, ckpt_dir):
    """The SMOKE train steps of the :data:`PART_2B` archs on every mesh of
    :data:`MESHES` (:func:`_train_case`), and the checkpoint of a jamba and
    an xlstm state saved from the (1, 2) mesh (the fused ``in_proj`` and
    ``up`` cut by parts), restored on the (1, 4) mesh and on one device,
    each compared bit for bit with the state saved."""
    import torch

    from repro_torch._tree import flatten
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import state_shardings
    from repro_torch.launch.train import build_state
    from repro_torch.models.layers import gather_params, shard_params

    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    ms = meshes(rank)
    same = {}
    for arch in PART_2B:
        states, batches = data[arch]
        for shape in MESHES:
            same[("train", arch, shape)] = _train_case(arch, states, batches, ms[shape], device,
                                                       GRAD_FLOOR)
    for arch in ("jamba-v0.1-52b", "xlstm-350m"):
        cfg = get_config(arch, smoke=True)
        whole = build_state(cfg, 0, device)
        whole["opt"]["step"] = torch.tensor(3)
        half = ms[(1, 2)]
        path = f"{ckpt_dir}/{arch}-half{rank // 2}"
        specs = state_shardings(cfg, half)
        CheckpointManager(CheckpointConfig(path, async_save=False), half, specs).save(
            3, shard_params(whole, specs, half))
        import torch.distributed as dist

        dist.barrier()
        restored = {}
        for shape in ((1, 4), None):
            mesh = ms[shape] if shape else None
            sp = state_shardings(cfg, mesh) if mesh else None
            proto = shard_params(whole, sp, mesh) if mesh else whole
            tree, step, _ = CheckpointManager(CheckpointConfig(path), mesh, sp).restore(proto)
            if mesh is not None:
                tree = gather_params(tree, sp, mesh)
            restored[shape] = (step, all(torch.equal(a, b) for (_, a), (_, b)
                                         in zip(flatten(tree), flatten(whole))))
        same[("checkpoint", arch)] = restored
    return {"same": same}


def cli_results(rank, world, device, ckpt):
    """The serve and train CLIs with ``--model-parallel 2 --dist-backend gloo
    --device cpu`` on the world's 4 ranks (a (2, 2) mesh), the train run
    checkpointing to ``ckpt``; and both CLIs for each part-2b arch on that
    mesh."""
    from repro_torch.launch import serve, train

    toks = serve.run(SERVE_ARGS + MESH_ARGS)
    losses = train.run(TRAIN_ARGS + MESH_ARGS + ["--ckpt", ckpt, "--ckpt-every", "2"])
    part2b = {arch: (serve.run(["--arch", arch] + SERVE_ARGS + MESH_ARGS),
                     train.run(["--arch", arch] + PART_2B_TRAIN_ARGS + MESH_ARGS))
              for arch in PART_2B}
    return {"tokens": toks, "losses": losses, "part2b": part2b}


MESH_ARGS = ["--model-parallel", "2", "--dist-backend", "gloo"]
SERVE_ARGS = ["--smoke", "--device", "cpu", "--requests", "6", "--batch", "4",
              "--prompt-len", "8", "--gen", "4"]
TRAIN_ARGS = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
              "--log-every", "1"]
PART_2B_TRAIN_ARGS = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
                      "--log-every", "1"]
