"""The JAX package's ``make_shardmap_train_step`` on a 2-device CPU mesh,
for ``tests/test_torch_distributed.py`` (run in a process of its own: the
device count is fixed before JAX starts).

    python tests/jax_shardmap_reference.py OUT.npz INPUTS.npz [CASES]

``INPUTS.npz`` holds ``tokens`` (steps, batch, seq).  For each case of
``CASES`` (comma-separated names of :data:`CASES`; default ``adamw,gum``:
AdamW, and GUM with ``fuse_families``; ``gum_bf16`` is that GUM on
bf16-stored parameters), ``shard_state`` off and on, it runs one step per
batch from ``model.init(PRNGKey(0))`` and writes the losses
(``<case>/losses``) and the final parameters as fp32 (``<case>/<path>``; a
bf16 leaf's cast is exact).  The mesh is built with ``AxisType.Auto``:
under jax 0.9's default Explicit axes the reference's sharded state raises.
"""
import sys

from repro.launch.devices import force_host_device_count

force_host_device_count(2)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import _leaf_paths  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.core import OptimizerConfig, build_optimizer  # noqa: E402
from repro.launch.shardmap_fsdp import make_shardmap_train_step  # noqa: E402
from repro.models import build_model  # noqa: E402

GUM = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3, fuse_families=True)
# name -> (optimizer config, ModelConfig.param_dtype)
CASES = {"adamw": (dict(name="adamw", lr=1e-3), "float32"),
         "gum": (GUM, "float32"),
         "gum_bf16": (GUM, "bfloat16")}


def main(out: str, inputs: str, cases: str = "adamw,gum") -> None:
    tokens = np.load(inputs)["tokens"]
    mesh = jax.make_mesh((2,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    result = {}
    for name in cases.split(","):
        cfg, param_dtype = CASES[name]
        model = build_model(get_smoke("llama-60m").replace(param_dtype=param_dtype))
        for shard_state in (False, True):
            case = f"{name}_{'shard' if shard_state else 'replicated'}"
            opt = build_optimizer(OptimizerConfig(kernel_impl="jnp", **cfg))
            params = model.init(jax.random.PRNGKey(0))
            state = opt.init(params)
            _, build = make_shardmap_train_step(model, opt, mesh, shard_state=shard_state)
            step = build(params, state)
            losses = []
            for t in tokens:
                params, state, metrics = step(params, state, {"tokens": jax.numpy.asarray(t)})
                losses.append(float(metrics["loss"]))
            result[f"{case}/losses"] = np.asarray(losses, np.float64)
            for path, leaf in zip(_leaf_paths(params), jax.tree_util.tree_leaves(params)):
                result[f"{case}/{path}"] = np.asarray(leaf, np.float32)
    np.savez(out, **result)


if __name__ == "__main__":
    main(*sys.argv[1:4])
