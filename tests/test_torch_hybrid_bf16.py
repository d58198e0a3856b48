"""The hybrid family (zamba2-1.2b) on bf16-stored parameters against the JAX
package, at its SMOKE config, from the reference's own initial draws: the
checks and tolerances of ``tests/test_torch_ssm_bf16.py`` (leaf dtypes;
logits, loss and every gradient at "xla" with fp32 and bf16 activations; the
prefill at "pallas" against "interpret"; 6 decode steps and the engine
against the reference's; a 3-step GUM ``Trainer``).  The shared block's
seven matrices are bf16 and its two unstacked norms fp32, as the
reference's cast leaves them.
"""
import pytest

from test_torch_bf16_train import check_trainer_case
from test_torch_ssm_bf16 import (
    ACTS,
    check_decode,
    check_engine,
    check_forward_and_grads,
    check_kernel_route,
    check_leaf_dtypes,
    reference_case,
)
from torch_threads import _one_thread  # noqa: F401  (autouse)

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def case():
    return reference_case(ARCH)


def test_leaf_dtypes_are_the_references(case):
    check_leaf_dtypes(ARCH, case, {"final_norm/norm_scale", "shared/ln1/norm_scale",
                                   "shared/ln2/norm_scale"})


@pytest.mark.parametrize("act", ACTS)
def test_logits_loss_and_grads_at_xla(case, act):
    check_forward_and_grads(ARCH, case, act)


@pytest.mark.parametrize("act", ACTS)
def test_prefill_at_pallas_matches_interpret(case, act):
    check_kernel_route(ARCH, case, act)


def test_decode_steps_match(case):
    check_decode(ARCH, case)


def test_engine_matches_reference_engine(case):
    check_engine(ARCH, case)


def test_gum_trainer_on_bf16_storage(tmp_path_factory):
    check_trainer_case(tmp_path_factory, ARCH, "gum", "float32")
