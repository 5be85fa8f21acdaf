"""The port's roofline (``repro_torch.launch.roofline``) and the dry run's
cells (``repro_torch.configs`` ``SHAPES``/``cell_supported``/``input_specs``,
``repro_torch.launch.report`` ``cache_bytes``/``model_bytes``) against the
reference's ``repro.launch.roofline``, ``repro.configs`` and
``repro.launch.report``, on the CPU.

The reference reads its counts from XLA; the port counts the ops one rank
dispatches (`CostCounter`).  What is compared exactly: the shape cells, the
analytic model FLOPs and bytes, the arithmetic of ``analyze`` and
``extrapolate`` (under the reference's constants), the per-kind collective
bytes of the counterpart of ``test_roofline_hlo_parsing``; and, for the
port's own count, that fake tensors count what real ones do, that the
full-depth count is the depth-1/depth-2 extrapolation (so the dry run needs
no trip-count correction), and that the
forward's matmul FLOPs are the analytic count from the config's dims.
Every comparison is exact (tolerance 0) unless a test says otherwise."""
import ast
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import collectives as tcoll  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402
from repro_torch.launch import roofline as trl  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402

ARCHS = jconfigs.ALL_ARCHS
SHAPE_NAMES = tuple(jconfigs.SHAPES)
_DT = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def use_reference_constants(monkeypatch):
    monkeypatch.setattr(trl, "PEAK_FLOPS", jrl.PEAK_FLOPS)
    monkeypatch.setattr(trl, "HBM_BW", jrl.HBM_BW)
    monkeypatch.setattr(trl, "LINK_BW", jrl.LINK_BW)
    monkeypatch.setattr(trl, "LINKS", jrl.ICI_LINKS)


def test_shapes_equal_the_reference():
    assert tuple(tconfigs.SHAPES) == SHAPE_NAMES
    for name, s in jconfigs.SHAPES.items():
        t = tconfigs.SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == (
            s.name, s.seq_len, s.global_batch, s.kind)
    assert tconfigs.ALL_ARCHS == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_equals_the_reference(arch):
    for name in SHAPE_NAMES:
        got = tconfigs.cell_supported(tconfigs.get_config(arch), tconfigs.SHAPES[name])
        want = jconfigs.cell_supported(jconfigs.get_config(arch), jconfigs.SHAPES[name])
        assert got == want, (arch, name)
        assert tconfigs.long_context_ok(tconfigs.get_config(arch)) == \
            jconfigs.base.long_context_ok(jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    for name in SHAPE_NAMES:
        got = tconfigs.input_specs(tconfigs.get_config(arch), tconfigs.SHAPES[name])
        want = jconfigs.input_specs(jconfigs.get_config(arch), jconfigs.SHAPES[name])
        assert sorted(got) == sorted(want), (arch, name)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (arch, name, k)
            assert got[k].dtype == _DT[str(w.dtype)], (arch, name, k)
            assert got[k].device.type == "meta"


def test_input_specs_of_the_reference_dryrun_api_smoke():
    """``tests/test_distributed.py``'s ``test_dryrun_cell_api_smoke`` on the port."""
    S = tconfigs.SHAPES
    cfg = tconfigs.get_config("llama3.2-1b")
    assert tconfigs.input_specs(cfg, S["train_4k"])["tokens"].shape == (256, 4096)
    assert tconfigs.input_specs(cfg, S["decode_32k"])["tokens"].shape == (128, 1)
    w = tconfigs.get_config("whisper-large-v3")
    frames = tconfigs.input_specs(w, S["prefill_32k"])["frames"]
    assert frames.shape == (32, 1500, 128) and frames.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_bytes_and_cache_bytes_equal_the_reference(arch):
    tc, jc = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for name in SHAPE_NAMES:
        ts, js = tconfigs.SHAPES[name], jconfigs.SHAPES[name]
        assert trl.model_flops(tc, ts) == jrl.model_flops(jc, js), name
        assert treport.cache_bytes(tc, ts) == jreport.cache_bytes(jc, js), name
        assert treport.model_bytes(tc, ts) == jreport.model_bytes(jc, js), name


def test_report_enrichment_math():
    """``tests/test_perf_variants.py``'s ``test_report_enrichment_math`` on the port."""
    cfg = tconfigs.get_config("llama3.2-1b")
    assert treport.model_bytes(cfg, tconfigs.SHAPES["train_4k"]) > 24 * cfg.param_count()
    assert treport.model_bytes(cfg, tconfigs.SHAPES["decode_32k"]) > 2 * cfg.param_count()


def test_constants_are_the_h100s():
    assert "NVIDIA H100 80GB HBM3" in trl.__doc__
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.LINK_BW, trl.LINKS) == (989e12, 3.35e12, 25e9, 18)


@pytest.mark.parametrize("seed", range(4))
def test_extrapolate_equals_the_reference(seed, monkeypatch):
    use_reference_constants(monkeypatch)
    rng = np.random.default_rng(seed)
    c1 = {k: float(rng.uniform(1e9, 1e12)) for k in ("flops", "bytes", "coll_bytes")}
    c2 = {k: c1[k] + float(rng.uniform(-1e8, 1e12)) for k in c1}
    P, chips = int(rng.integers(1, 100)), int(rng.choice([256, 512]))
    mf = float(rng.uniform(1e15, 1e18))
    got = trl.extrapolate(c1, c2, P, n_chips=chips, model_flops_global=mf)
    want = jrl.extrapolate(c1, c2, P, n_chips=chips, model_flops_global=mf)
    assert got == want


class _Compiled:
    """A stand-in for the reference's compiled artifact."""

    def __init__(self, flops, byts):
        self._ca = {"flops": flops, "bytes accessed": byts}

    def cost_analysis(self):
        return self._ca


@pytest.mark.parametrize("override", [None, 3.5e9])
def test_analyze_equals_the_reference(override, monkeypatch):
    use_reference_constants(monkeypatch)
    hlo = ("  %ar = bf16[1024] all-reduce(%x), replica_groups={}\n"
           "  %ag.1 = f32[2048] all-gather(%y), dimensions={0}\n"
           "  %cp = u8[100] collective-permute(%z)\n")
    cost = {"flops": 7.5e12, "bytes": 1e9, "bytes_raw": 9.25e10, "coll_bytes": 2048 + 8192 + 100,
            "coll_ops": 3}
    got = trl.analyze(cost, n_chips=256, model_flops_global=1.1e15, mem_bytes_override=override)
    want = jrl.analyze(_Compiled(7.5e12, 9.25e10), hlo, n_chips=256, model_flops_global=1.1e15,
                       mem_bytes_override=override)
    assert got.as_dict() == want.as_dict()


def test_collectives_counted_per_kind():
    """The counterpart of ``test_roofline_hlo_parsing``: in a fake 4-rank
    world, a psum of bf16[1024], an all_gather to f32[2048] and a ppermute
    of u8[100] count at their output bytes under the reference's HLO names;
    a local add counts nothing there."""
    with tdry.fake_world(4):
        mesh = tcoll.make_mesh((("x", 4),), range(4))
        ax = mesh.axis("x")
        with trl.CostCounter() as c:
            tcoll.psum(torch.zeros(1024, dtype=torch.bfloat16), ax)
            g = tcoll.all_gather(torch.zeros(512, dtype=torch.float32), ax)
            ring = [(0, 1), (1, 2), (2, 3), (3, 0)]
            tcoll.ppermute(torch.zeros(100, dtype=torch.uint8), ax, ring)
            torch.zeros(4) + torch.ones(4)
    assert g.numel() * g.element_size() == 8192
    assert c.coll == {"all-gather": 8192, "all-reduce": 2048, "reduce-scatter": 0,
                      "all-to-all": 0, "collective-permute": 100, "n_ops": 3}
    assert c.totals()["coll_bytes"] == 2048 + 8192 + 100
    # the transport inside the collectives (the psum's gather and adds) is not counted
    assert c.ops["aten.add"] == 1 and c.flops == 0
    assert not torch.distributed.is_initialized()


def test_autograd_collectives_counted_by_meaning():
    """reduce_from and the backward of copy_to are all-reduces, gather_from
    an all-gather; pmean and pmax count once (their inner psum and gather
    are transport)."""
    with tdry.fake_world(4):
        mesh = tcoll.make_mesh((("x", 4),), range(4))
        ax = mesh.axis("x")
        x = torch.zeros(8, 16, requires_grad=True)
        with trl.CostCounter() as c:
            y = tcoll.gather_from(tcoll.copy_to(x, ax), ax, 1)           # 8 × 64 f32
            z = tcoll.reduce_from(y, ax)
            z.sum().backward()                                            # copy_to's psum
            tcoll.pmean(torch.zeros(10), ax)
            tcoll.pmax(torch.zeros(10), ax)
        assert c.coll["all-gather"] == 8 * 64 * 4
        assert c.coll["all-reduce"] == 8 * 64 * 4 + 8 * 16 * 4 + 40 + 40
        assert c.coll["n_ops"] == 5


def _smoke_step(device_kind, mesh=None):
    """(step, args) of the llama3.2-1b SMOKE train step on batch 4 × 16:
    real CPU tensors from seed 0, or fake ones of the same shapes."""
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    shape = tconfigs.ShapeConfig("t", 16, 4, "train")
    if device_kind == "fake":
        return tdry.build_cell(cfg, shape, mesh, None, "cpu")
    params = init_params(TT.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu")
    if mesh is not None:
        from repro_torch.models.layers import shard_params
        params = shard_params(params, tsteps.shardings_for_params(cfg, mesh), mesh)
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)), dtype=torch.int32)
    state = {"params": params, "opt": adamw_init(params)}
    step = tsteps.make_train_step(cfg, AdamWConfig(), mesh=mesh)
    return step, (state, {"tokens": tok, "labels": tok.clone()})


def _count_smoke(kind, mesh=None):
    if kind == "fake":
        with tdry.fake_mode():
            fn, args = _smoke_step("fake", mesh)
            return tdry.count(fn, args)[0]
    fn, args = _smoke_step("real", mesh)
    return tdry.count(fn, args)[0]


def test_fake_count_equals_real_count_one_rank():
    real, fake = _count_smoke("real"), _count_smoke("fake")
    assert real.totals() == fake.totals()
    assert real.ops == fake.ops
    assert real.flops > 0 and real.bytes > 0 and real.bytes_raw > real.bytes


def test_fake_count_equals_real_count_on_a_fake_mesh():
    """On a (2, 2) mesh of a fake 4-rank world (the collectives move
    nothing, so the real run's values are garbage; the count is not)."""
    with tdry.fake_world(4):
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=2)
        real, fake = _count_smoke("real", mesh), _count_smoke("fake", mesh)
    assert real.totals() == fake.totals()
    assert real.coll == fake.coll and real.coll["n_ops"] > 0


def test_full_depth_count_equals_the_extrapolation():
    """Eager counting sees every period, so the reference's affine
    extrapolation from depth 1 and depth 2 gives the full-depth count back:
    the dry run needs no trip-count correction."""
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True).replace(n_layers=5)
    shape = tconfigs.ShapeConfig("t", 16, 4, "train")

    def cost(c):
        with tdry.fake_mode():
            return tdry.count(*tdry.build_cell(c, shape, None, None, "cpu"))[0].totals()
    full = cost(cfg)
    c1, c2 = cost(cfg.replace(n_layers=1)), cost(cfg.replace(n_layers=2))
    ex = trl.extrapolate(c1, c2, cfg.n_periods, n_chips=1, model_flops_global=1.0)
    assert ex["flops_per_chip"] == full["flops"]
    assert ex["bytes_per_chip"] == full["bytes"]
    assert ex["collective_bytes_per_chip"] == full["coll_bytes"] == 0


def test_forward_matmul_flops_equal_the_analytic_count():
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    B, S = 3, 16
    d, hd, H, Hkv, F, V = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab
    per_layer = (2 * B * S * d * (H + 2 * Hkv) * hd      # q, k, v projections
                 + 2 * B * S * H * hd * d                # output projection
                 + 4 * B * H * S * S * hd                # scores and P·V (naive: every pair)
                 + 3 * 2 * B * S * d * F)                # gated MLP
    want = cfg.n_layers * per_layer + 2 * B * S * d * V  # + the (tied) head
    with tdry.fake_mode():
        params = tsteps.param_blocks(cfg, None, "cpu")
        tok = torch.zeros((B, S), dtype=torch.int32)
        with torch.no_grad(), trl.CostCounter() as c:
            TT.forward(params, {"tokens": tok}, cfg)
    assert c.flops == want


def test_memory_high_water_mark():
    """Temporaries are counted from their first op until freed; arguments
    are not temporaries."""
    a = torch.zeros(1000)
    with trl.CostCounter() as c:
        c.add_arguments([a])
        b = a + 1            # 4000 live
        d = b * 2            # 8000 live
        del b
        e = d.view(10, 100) + 0   # 8000 live again (b freed), no new high
        a.add_(1)            # in place on an argument: nothing new
    assert c.argument_bytes == 4000 and c.temp_peak_bytes == 8000
    del d, e
    assert c.live_bytes == 0


def test_flash_custom_ops_fake_shapes_and_flop_formula():
    """The flash launch as a custom op: its fake output is q's shape and
    dtype, and it counts 4·B·Hq·S·T·D (a causal mask does not halve it, as
    for SDPA; a split's combine is inside the op and adds nothing)."""
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, S, T, D = 2, 8, 2, 16, 40, 64
    launched = (fa.flash_attention.launches, fa.flash_attention.combine_launches)
    with tdry.fake_mode():
        q = torch.empty(B, Hq, S, D, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(B, Hkv, T, D, dtype=torch.bfloat16, device="cuda")
        with trl.CostCounter() as c:
            o = torch.ops.repro_torch.flash_attention(q, k, k, True)
            p = torch.ops.repro_torch.flash_attention(q, k, k, False)
    for r in (o, p):
        assert r.shape == q.shape and r.dtype == torch.bfloat16 and r.device.type == "cuda"
    assert c.flops == 2 * 4 * B * Hq * S * T * D
    assert c.ops["repro_torch.flash_attention"] == 2 and len(c.ops) == 1
    # the kernel's output is an anchor: 2 × its output bytes
    assert c.bytes == 2.0 * 2 * o.numel() * 2
    # a fake call launches nothing
    assert (fa.flash_attention.launches, fa.flash_attention.combine_launches) == launched


def test_flash_wrapper_on_the_cpu_takes_the_plain_version():
    """On a CPU tensor the wrapper never reaches the custom op."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((1, 4, 8, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((1, 2, 8, 16)), dtype=torch.float32)
    with trl.CostCounter() as c:
        out = fa.flash_attention(q, k, k, True)
    assert "repro_torch.flash_attention" not in c.ops
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, k, True), rtol=0, atol=0)


@pytest.mark.parametrize("mod", [tconfigs.base, trl, tdry, treport, tsteps, tcoll])
def test_port_modules_import_no_jax(mod):
    tree = ast.parse(inspect.getsource(mod))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "repro")]
