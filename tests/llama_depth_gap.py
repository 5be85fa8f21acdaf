#!/usr/bin/env python3
"""How far the port's llama3.2-1b gradient is from the JAX package's, by depth, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/llama_depth_gap.py \\
        [--layers 1,2,4] [--dtypes float32,bfloat16]

A comparison tool beside the tests (it imports both packages, as they do;
pytest does not collect it: at full width it needs gigabytes of host memory).

llama3.2-1b at its full widths (d_model 2048, 32:8 heads of 64, d_ff 8192,
vocab 128256) cut to a few layers, params from the reference's
``init_params(key 0)`` carried across with ``convert``, one batch of the
synthetic pipeline (seed 0, batch 2, seq 16), ``attn_impl="naive"``, no
remat.  One JSON line per (layers, dtype): both packages' loss and global
gradient norm and their relative gaps.  Under the reference's init rules the
gradient grows by about an order of magnitude a layer, and so does any
rounding difference between two implementations.  Needs about 3 GB of host
memory a layer count at 1-2 layers and 6 GB at 4.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", default="1,2,4")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro.models.layers import init_params
    from repro_torch import convert
    from repro_torch._tree import leaves
    from repro_torch.configs import get_config as torch_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch.steps import loss_and_grads

    for n_layers in (int(x) for x in args.layers.split(",")):
        for dtype in args.dtypes.split(","):
            kw = dict(n_layers=n_layers, dtype=dtype, attn_impl="naive", remat=False)
            jcfg = jax_config("llama3.2-1b").replace(**kw)
            tcfg = torch_config("llama3.2-1b").replace(**kw)
            params = jax.tree.map(np.asarray,
                                  init_params(JT.abstract_params(jcfg), jax.random.key(0)))
            batch = _synthesize(DataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=2,
                                           seed=0), 0)
            (loss_j, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: JT.loss(p, b, jcfg), has_aux=True))(
                    jax.tree.map(jnp.asarray, params),
                    {k: jnp.asarray(v) for k, v in batch.items()})
            norm_j = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                                        for g in jax.tree.leaves(grads))))
            del grads
            loss_t, _, grads = loss_and_grads(
                convert.model_params_to_torch(params, "cpu"),
                {k: torch.as_tensor(v).long() for k, v in batch.items()}, tcfg)
            norm_t = float(torch.sqrt(sum((g.float() ** 2).sum() for g in leaves(grads))))
            print(json.dumps(dict(
                layers=n_layers, dtype=dtype, loss_ref=float(loss_j), loss_port=float(loss_t),
                loss_gap=abs(float(loss_t) - float(loss_j)) / abs(float(loss_j)),
                grad_norm_ref=norm_j, grad_norm_port=norm_t,
                grad_norm_gap=abs(norm_t - norm_j) / norm_j)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
