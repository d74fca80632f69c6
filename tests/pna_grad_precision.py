"""How far PNA's fp32 training gradients stand from float64, in both
packages, at the ``molecule`` width.

The reference's parameters (``init_pna``, key 0) and one batch of
molecule-like graphs (``torch_parity.molecule_graphs``, seed ``--seed``,
labels in {0, 1}) go through ``loss_dense(use_kernel=False)``: the JAX
reference in fp32, the port in fp32 and the port in float64.  Printed
per parameter: the relative L2 distance of each fp32 gradient to the
port's float64 one.  ``--fp32-moments`` runs the port with the
aggregator's moments in fp32 and ``clamp_min`` (the arithmetic before
they moved to float64), to show what that choice buys.  CPU only:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/pna_grad_precision.py \\
        [--batch 128] [--seed 128] [--fp32-moments]

The last line of the output is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import gnn as jgnn
from repro_torch.configs import get_arch
from repro_torch.convert import param_arrays
from repro_torch.kernels.pna_aggregate import ref as pna_ref
from repro_torch.models.gnn import loss_dense
from repro_torch.train.loop import value_and_grad
from torch_parity import molecule_graphs, port_pna


def _fp32_moments(cnt, s, ssq):
    denom = cnt.clamp_min(1.0)
    mean = s / denom
    var = (ssq / denom - mean * mean).clamp_min(0.0)
    return mean, torch.sqrt(var + 1e-12)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=128)
    ap.add_argument("--fp32-moments", action="store_true")
    args = ap.parse_args(argv)
    if args.fp32_moments:
        pna_ref._moments = _fp32_moments

    jarch, arch = jax_get_arch("pna"), get_arch("pna")
    jcfg, cfg = (a.config(shape="molecule") for a in (jarch, arch))
    jparams = jarch.init(jcfg, jax.random.PRNGKey(0))
    n = 30
    adj, feats = molecule_graphs(args.batch, n, cfg.d_in, seed=args.seed)
    labels = np.random.default_rng(args.seed).integers(
        0, 2, args.batch).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jgnn.loss_dense(
        jcfg, p, jnp.asarray(feats), jnp.asarray(adj), jnp.asarray(labels),
        use_kernel=False))(jparams)

    def port(dtype):
        model = port_pna(jparams, cfg).to(dtype)
        c = dataclasses.replace(cfg, dtype=dtype)
        batch = {"feats": torch.from_numpy(feats).to(dtype),
                 "adj": torch.from_numpy(adj).to(dtype),
                 "labels": torch.from_numpy(labels)}
        return value_and_grad(lambda m, b: loss_dense(
            c, m, b["feats"], b["adj"], b["labels"], use_kernel=False),
            model, batch), model

    (l32, g32), model = port(torch.float32)
    (l64, g64), _ = port(torch.float64)
    ref = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    out = {"loss": {"reference_fp32": float(jl), "port_fp32": float(l32),
                    "port_fp64": float(l64)}, "rel_l2_to_fp64": {}}
    for k, t in g64.items():
        t = t.numpy()
        norm = float(np.linalg.norm(t))
        row = {"port_fp32": float(np.linalg.norm(g32[k].double().numpy()
                                                 - t)) / norm,
               "reference_fp32": float(np.linalg.norm(ref[k] - t)) / norm}
        out["rel_l2_to_fp64"][k] = row
        print(f"{k:16s} port fp32 {row['port_fp32']:.3g}  "
              f"reference fp32 {row['reference_fp32']:.3g}")
    out.update(batch=args.batch, seed=args.seed,
               fp32_moments=args.fp32_moments)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
