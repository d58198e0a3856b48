"""Rematerialisation in the port's models, and the chunked loss under it.

``ModelConfig.remat`` runs each layer under ``torch.utils.checkpoint`` when
autograd records, as the reference wraps each layer in ``jax.checkpoint``
(``src/repro/models/transformer.py:_remat``): ``remat_policy="dots"`` keeps
the outputs of the un-batched products (``aten.mm``, ``aten.addmm``), any
other policy keeps nothing.  Recomputation runs the same fp32 ops on the
same inputs, so the loss and every gradient are bitwise those without remat.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, lm_loss
from repro_torch.models.transformer import Transformer
from torch_threads import _one_thread  # noqa: F401  (autouse)


ARCHS = ["llama-60m", "mamba2-370m"]


def _tokens(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (2, 24), generator=gen)


def _loss_and_grads(cfg, params, tokens):
    model = build_model(cfg, device="cpu")
    model.load_params(params)
    ps = model.params()
    loss = lm_loss(model(tokens), tokens)
    return loss, dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    cfg = get_smoke(request.param)
    assert not cfg.remat  # the smoke configs turn it off; the tests turn it on
    model = build_model(cfg, device="cpu")
    model.init_params(0)
    params = {k: v.detach().clone() for k, v in model.params().items()}
    tokens = _tokens(cfg)
    return cfg, params, tokens, _loss_and_grads(cfg, params, tokens)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gives_the_same_loss_and_gradients(smoke, policy):
    cfg, params, tokens, (want_loss, want_grads) = smoke
    loss, grads = _loss_and_grads(cfg.replace(remat=True, remat_policy=policy), params, tokens)
    assert torch.equal(loss, want_loss)
    assert list(grads) == list(want_grads)
    for path, g in grads.items():
        assert torch.equal(g, want_grads[path]), path


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it, by name."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(cfg, params, tokens) -> dict[str, int]:
    """The aten ops that the backward pass runs: the gradient's own and,
    under remat, the recomputed forward."""
    model = build_model(cfg, device="cpu")
    model.load_params(params)
    ps = model.params()
    loss = lm_loss(model(tokens), tokens)
    with _CountOps() as ops:
        torch.autograd.grad(loss, list(ps.values()))
    return ops.counts


def test_remat_recomputes_what_its_policy_does_not_save():
    """On the dense decoder: without remat the backward runs no forward op
    again; with "nothing" it recomputes each layer, its products (mm for the
    projections, bmm for attention) included; with "dots" it recomputes the
    batched attention products and the elementwise work, but no mm."""
    cfg = get_smoke("llama-60m")
    model = build_model(cfg, device="cpu")
    model.init_params(0)
    params = {k: v.detach().clone() for k, v in model.params().items()}
    tokens = _tokens(cfg)
    off = _backward_ops(cfg, params, tokens)
    nothing = _backward_ops(cfg.replace(remat=True, remat_policy="nothing"), params, tokens)
    dots = _backward_ops(cfg.replace(remat=True, remat_policy="dots"), params, tokens)
    # The recomputation stops once it has every tensor backward needs, so
    # it may skip a layer's last ops (w_out's product): count no exact mm.
    assert nothing["mm"] >= off["mm"] + 4 * cfg.n_layers  # at least q, k, v, o
    assert dots["mm"] == off["mm"]
    assert nothing["bmm"] > off["bmm"] and dots["bmm"] == nothing["bmm"]
    assert nothing.get("rsqrt", 0) > off.get("rsqrt", 0)
    assert dots.get("rsqrt", 0) == nothing.get("rsqrt", 0)


def test_remat_is_off_without_autograd():
    """A forward under no_grad (prefill, serving) runs no checkpoint: the
    same logits, and no recomputation to pay for."""
    cfg = get_smoke("llama-60m")
    model = build_model(cfg.replace(remat=True), device="cpu")
    model.init_params(0)
    plain = build_model(cfg, device="cpu")
    plain.load_params({k: v.detach() for k, v in model.params().items()})
    tokens = _tokens(cfg)
    with torch.no_grad():
        assert torch.equal(model(tokens), plain(tokens))


def test_logit_chunk_raises_until_the_chunked_loss_is_ported():
    """The chunked loss is ported: ``logit_chunk=8`` builds, and the train
    step's loss and gradients (``launch.steps.loss_and_grads``), with remat
    on, come through the chunked loss, within 1e-6 (loss) and 1e-5
    (gradients) of the unchunked ones.  (The name dates from when
    ``logit_chunk > 0`` raised; it is kept so this check keeps one record.)"""
    from repro_torch.launch.steps import loss_and_grads

    cfg = get_smoke("llama-60m").replace(logit_chunk=8, remat=True)
    chunked = build_model(cfg, device="cpu")
    assert isinstance(chunked, Transformer)
    chunked.init_params(0)
    plain = build_model(cfg.replace(logit_chunk=0), device="cpu")
    plain.load_params({k: v.detach() for k, v in chunked.params().items()})
    batch = {"tokens": _tokens(cfg)}
    loss, grads = loss_and_grads(chunked, chunked.params(), batch)
    want_loss, want_grads = loss_and_grads(plain, plain.params(), batch)
    assert abs(float(loss - want_loss)) <= 1e-6 * float(want_loss)
    for k, want in want_grads.items():
        assert float((grads[k] - want).abs().max()) <= 1e-5 * float(want.abs().max()), k
    opt = build_optimizer(OptimizerConfig(name="adamw", lr=1e-3))
    params = chunked.params()
    _, metrics = make_train_step(chunked, opt)(params, opt.init(dict(params)), batch)
    assert float(metrics["loss"]) == float(loss)
