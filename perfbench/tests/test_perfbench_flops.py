"""The counted operations and bytes equal counts made by hand."""
import itertools

from perfbench import flops
from perfbench.flops import Sizes


def brute_pairs(S, T, causal, q_offset):
    o = T - S if q_offset is None else q_offset
    return sum(1 for i, t in itertools.product(range(S), range(T)) if not causal or t <= o + i)


def test_visible_pairs():
    for S, T, causal, off in [(5, 5, True, None), (1, 9, True, None), (4, 9, True, 0),
                              (4, 9, True, 7), (6, 3, False, None), (3, 8, True, 2)]:
        assert flops.visible_pairs(S, T, causal, off) == brute_pairs(S, T, causal, off)


def test_attention_core_by_hand():
    # 2 requests, 4 query heads on 2 kv heads, 3 causal queries over 3 keys, D = 8, bf16
    ops, nbytes = flops.attention_core(2, 4, 2, 3, 3, 8, True, None, 2)
    assert ops == 4 * 2 * 4 * 8 * (1 + 2 + 3)
    assert nbytes == 2 * (2 * 2 * 4 * 3 * 8 + 2 * 2 * 2 * 3 * 8)


def test_moe_decoder_request_by_hand():
    z = Sizes(d=8, layers=2, heads=2, kv_heads=1, head_dim=4, vocab=10, experts=4, top_k=2,
              expert_ff=6)
    S, G = 3, 2
    n = S + G - 1
    per_pos = 2 * 8 * (2 * 2 * 4 + 2 * 1 * 4) + 2 * 8 * 4 + 2 * 3 * 2 * 8 * 6
    core = sum(4 * 2 * 4 * (p + 1) for p in range(n))
    assert flops.request_flops(z, S, G) == 2 * (n * per_pos + core) + G * 2 * 8 * 10


def test_encdec_request_by_hand():
    z = Sizes(d=8, layers=1, heads=2, kv_heads=2, head_dim=4, vocab=10, ff=16, gated=False,
              enc_layers=2, enc_seq=5, d_frontend=3)
    S, G = 2, 3
    n = S + G - 1
    proj = 2 * 8 * 8 * 4                       # q, k, v, o of one position
    mlp = 2 * 2 * 8 * 16
    enc = 2 * 5 * 3 * 8 + 2 * (5 * (proj + mlp) + 4 * 8 * 5 * 5)
    cross_kv = 1 * 5 * 2 * 2 * 8 * 8
    dec = n * (proj + mlp) + sum(4 * 8 * (p + 1) for p in range(n))
    cross = n * (2 * 2 * 8 * 8 + 4 * 8 * 5)
    head = G * 2 * 8 * 10
    assert flops.request_flops(z, S, G) == enc + cross_kv + dec + cross + head


def test_sizes_of_the_configurations(tiny_root):
    import json

    w = json.loads((tiny_root / "perfbench/configs/whisper-large-v3.json").read_text())
    p = json.loads((tiny_root / "perfbench/configs/phi3.5-moe-16L.json").read_text())
    zw, zp = flops.sizes_of(w), flops.sizes_of(p)
    assert (zw.d, zw.heads, zw.head_dim, zw.ff, zw.enc_seq) == (1280, 20, 64, 5120, 1500)
    assert (zp.d, zp.kv_heads, zp.head_dim, zp.experts, zp.expert_ff) == (4096, 8, 128, 16, 6400)
