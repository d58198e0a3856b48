"""The JAX package's pjit ``Trainer`` on a CPU mesh of forced host devices,
for ``tests/test_torch_fsdp.py`` (a 2-device data mesh) and
``tests/test_torch_tensor_parallel.py`` (a (data=2, model=2) mesh of 4); run
in a process of its own: the device count is fixed before JAX starts.

    python tests/jax_pjit_reference.py OUT.npz STEPS [SHAPE]

``SHAPE`` is ``2`` (the default: axes ``("data",)``) or ``D,T`` (axes
``("data", "model")``).

GUM (``rank=4, gamma=1, period=3``, ``fuse_families``) on llama-60m
``SMOKE`` from ``model.init(PRNGKey(0))``, ``global_batch=4, seq_len=64``:
the ``Trainer`` places every parameter by ``named_sharding_tree`` (the
``fsdp`` rules on the data axis, the ``tp`` rules on the model axis).  It writes the losses (``losses``) and the
final parameters as fp32 (``<path>``).  The mesh is built with
``AxisType.Auto``, as ``tests/jax_shardmap_reference.py`` builds it.
"""
import math
import sys
import tempfile

from repro.launch.devices import force_host_device_count

SHAPE = tuple(int(n) for n in (sys.argv[3] if len(sys.argv) > 3 else "2").split(","))
AXES = ("data", "model")[:len(SHAPE)]
force_host_device_count(math.prod(SHAPE))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import _leaf_paths  # noqa: E402
from repro.configs import RunConfig, get_smoke  # noqa: E402
from repro.core import OptimizerConfig  # noqa: E402
from repro.data import DataConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.train import Trainer  # noqa: E402

GUM = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3, fuse_families=True)


def main(out: str, steps: str) -> None:
    mesh = jax.make_mesh(SHAPE, AXES, axis_types=(jax.sharding.AxisType.Auto,) * len(SHAPE))
    cfg = get_smoke("llama-60m")
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(build_model(cfg), OptimizerConfig(kernel_impl="jnp", **GUM),
                          RunConfig(steps=int(steps), ckpt_dir=d, ckpt_every=0, log_every=0,
                                    resume=False, seed=0),
                          DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0),
                          mesh=mesh)
        losses = trainer.train().losses
        (params, _), _ = trainer.ckpt.restore(int(steps), trainer.init_state())
    result = {"losses": np.asarray(losses, np.float64)}
    for path, leaf in zip(_leaf_paths(params), jax.tree_util.tree_leaves(params)):
        result[path] = np.asarray(leaf, np.float32)
    np.savez(out, **result)


if __name__ == "__main__":
    main(*sys.argv[1:3])
