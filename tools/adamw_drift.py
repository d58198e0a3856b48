#!/usr/bin/env python3
"""Where the port's AdamW leaves leave the reference's: GUM on llama-60m
SMOKE (rank 8, gamma 1, period 3, lr 5e-3, the trainer's clip 1.0, seq 64,
batch 2; the recipe of ``tests/test_torch_rank_policy.py``'s trainer test
without the policy), both packages stepped side by side from the
reference's initial parameters with its block draws injected, on the CPU.

    PYTHONPATH=src python3 tools/adamw_drift.py [--steps 10] [--leaf embed/embed]

After each step, for the AdamW leaf, max |port − reference| (and that over
max |reference|) of: the parameter; the gradient each package takes at its
own parameters; the port's gradient at the *reference's* parameters (the
forward and backward alone, no drift); Adam's two moments; and the step's
update.  After step 1 it also prints the entry whose update differs most,
and the update's distance over the entries with |g| above and below 1e-6.
Imports both packages (a tool, not part of the port).
"""
import argparse
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.core import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.core import build_optimizer as j_build_optimizer  # noqa: E402
from repro.core.api import tree_paths  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import build_stream as j_build_stream  # noqa: E402
from repro.launch.steps import _loss_from_batch as j_loss  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import OptimizerConfig, build_optimizer  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from test_torch_trainer import jax_sampler  # noqa: E402

OPT = dict(name="gum", lr=5e-3, rank=8, gamma=1, period=3)


def flat(tree) -> dict:
    paths = jax.tree_util.tree_leaves(tree_paths(tree))
    return dict(zip(paths, (np.asarray(x) for x in jax.tree_util.tree_leaves(tree))))


def dist(a, b) -> str:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b).max()
    return f"{d:.3e} ({d / max(np.abs(b).max(), 1e-30):.2e})"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--leaf", default="embed/embed")
    args = ap.parse_args()
    torch.set_num_threads(1)
    key = args.leaf

    jcfg = j_get_smoke("llama-60m")
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **OPT))
    jstate = jopt.init(jparams)
    jstep = jax.jit(j_make_train_step(jmodel, jopt, grad_clip=1.0))
    jgrad = jax.jit(jax.grad(lambda p, t: j_loss(jmodel, p, {"tokens": t}, jcfg)))

    model = build_model(get_smoke("llama-60m"), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    params = model.params()
    opt = build_optimizer(OptimizerConfig(**OPT), sampler=jax_sampler)
    state = opt.init({k: p.detach() for k, p in params.items()})
    step = make_train_step(model, opt, grad_clip=1.0)
    probe = build_model(get_smoke("llama-60m"), device="cpu")
    stream = j_build_stream(JDataConfig(vocab=jcfg.vocab, seq_len=64, global_batch=2, seed=0))

    print(f"leaf {key}: max |port - reference| (over max |reference|)")
    print("step | parameter | gradient at own parameters | port's gradient at the reference's "
          "parameters | mu | nu | update")
    for t in range(args.steps):
        tokens = next(stream)
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
        g_ref = flat(jgrad(jparams, jnp.asarray(tokens)))[key]
        probe.load_params(params_from_jax(jax.device_get(jparams)))
        g_at_ref = loss_and_grads(probe, probe.params(), batch)[1][key].numpy()
        g_own = loss_and_grads(model, params, batch)[1][key].numpy()
        before, j_before = params[key].detach().numpy().copy(), flat(jparams)[key]
        jparams, jstate, _ = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})
        state, _ = step(params, state, batch)
        p, jp = params[key].detach().numpy(), flat(jparams)[key]
        js, ts = flat(jstate), {k: v.numpy() for k, v in flatten_with_paths(state)
                                if isinstance(v, torch.Tensor)}
        mu = next(k for k in ts if k.endswith("/mu/" + key))
        nu = next(k for k in ts if k.endswith("/nu/" + key))
        upd, j_upd = p - before, jp - j_before
        print(f"{t + 1} | {dist(p, jp)} | {dist(g_own, g_ref)} | {dist(g_at_ref, g_ref)} | "
              f"{dist(ts[mu], js[mu])} | {dist(ts[nu], js[nu])} | {dist(upd, j_upd)}", flush=True)
        if t == 0:
            du = np.abs(upd - j_upd)
            i = np.unravel_index(np.argmax(du), du.shape)
            print(f"  the entry {tuple(int(x) for x in i)} whose update differs most: g reference "
                  f"{g_ref[i]:.6e}, port {g_own[i]:.6e}; mu {js[mu][i]:.6e} / {ts[mu][i]:.6e}; "
                  f"nu {js[nu][i]:.6e} / {ts[nu][i]:.6e}; update {j_upd[i]:.6e} / {upd[i]:.6e}")
            big = np.abs(g_ref) > 1e-6
            print(f"  update distance over the {int(big.sum())} entries with |g| > 1e-6: "
                  f"{du[big].max():.3e}; over the {int((~big).sum())} with |g| <= 1e-6: "
                  f"{du[~big].max():.3e}")


if __name__ == "__main__":
    main()
