"""The port's training path on the CPU against the JAX package, on the ten
reduced configurations of ``tests/torch_lm_train.npz`` (the reference's
parameters, batch, loss, gradient and one AdamW step; see
``test_torch_lm_train_fixture.py``).  One ``make_train_step`` of the port
from the same parameters and batch, with its gradients captured by the
``grad_transform`` hook, is held to the file:

* ``loss`` within atol 1e-2, ``aux`` (the MoE load-balance loss) within
  1e-3, ``lr`` within 1e-6 relative;
* each gradient leaf within a relative L2 error of 5e-2 (over the
  sampled elements, and the leaf's whole norm within 5e-2), ``grad_norm``
  within 2%; the moments ``m`` and ``v`` after the step as the gradient
  (``v`` at twice its tolerance: it squares the gradient);
* the new parameters: every element within ``2 lr (1 + wd |p|)`` plus
  one bf16 ulp (of the larger of the two) of the reference's (a gradient
  element of the other sign moves the first AdamW step by ``2 lr``), and
  at most 1% of the sampled elements more than one ulp apart.

Where the tolerances come from: bf16 rounds at other places in the two
packages (the reference's compiled scan fuses), and these random-weight
models amplify it.  On the fixture's batch the port's own gradient moves
by up to 16% of a leaf's norm (grad_norm 0.3%) for the reduced Llama, and
by up to 3.2x a leaf's norm (grad_norm 85%) for the reduced
recurrentgemma, when its fused rounding is replaced by op-by-op
rounding (``torch_parity.rounding_shift``); in fp32 the two packages
agree within 1e-5 (Llama) and 3e-3 (recurrentgemma: the log-depth scan
against ``associative_scan``).  So no bf16 bound can tell a wrong
recurrentgemma gradient from a rounding: its bf16 step is held on the
loss, aux, lr and step count only, and its gradient by
:func:`test_fp32_gradients_equal_jax`, in fp32 on the fixture's whole
batch of 80 positions, where its reduced window of 64 binds.  The other
nine are held to the tolerances above (``torch_parity.LM_TRAIN_TOL``).

The card's step rounds otherwise again: its GEMMs and exps, and the
forward kernels' bf16 P before P V (phi3.5-moe's grad_norm moves 24% by
that alone).  ``chip_smoke.py`` phase 21 holds it to
``LM_TRAIN_CARD_TOL``: per arch the CPU tolerance, 1.5x the error of a
CPU step with the kernels' P rounding emulated, or 1.25x the rounding
shift, whichever is largest;
:func:`test_card_tolerance_measurements_are_current` takes both
measurements again.  Those bounds are loose where the rounding moves
much, so phase 21 also holds the card's step with the backward kernel to
the same card step with ``attention_backward_plain`` in the kernel's
place, at ``torch_parity.BWD_STEP_TOL`` (every leaf within 5e-2):
there nothing but the backward differs.

The fixture also holds the JAX package's fp32 gradient of the reduced
llama3.2-1b and recurrentgemma-2b (``grad32``, sampled as the bf16
leaves): :func:`test_fp32_gradients_equal_fixture` holds the port's CPU
fp32 gradient to it at ``LM_TRAIN_FP32_TOL``, and ``chip_smoke.py`` phase
21 (c) the card's, on the fp32 attention kernels, at
``LM_TRAIN_FP32_CARD_TOL``.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from torch_parity import (LM_TRAIN_ARCHS, LM_TRAIN_CARD_TOL,
                          LM_TRAIN_FIXTURE, LM_TRAIN_FP32_ARCHS,
                          LM_TRAIN_FP32_TOL, LM_TRAIN_KERNEL_ROUNDING,
                          LM_TRAIN_ROUNDING_SHIFT, _f32, _rel,
                          attention_kernel_rounding, check_lm_train,
                          check_lm_train_fp32, flatten, load_lm_train,
                          lm_train_fp32_grads, lm_train_step,
                          rounding_shift)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_loss_grads_and_step_match_jax(arch):
    z = np.load(LM_TRAIN_FIXTURE)
    check_lm_train(arch, *lm_train_step(z, arch, "cpu"))


@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_card_tolerance_measurements_are_current(arch):
    """The two CPU measurements ``LM_TRAIN_CARD_TOL`` is made of, taken
    again: the step with the forward kernels' bf16 P emulated
    (``attention_kernel_rounding`` in place of the plain forward) and the
    rounding shift of the port's own gradient, each within 10% (+1e-3) of
    the recorded numbers; so the card's step is held no looser than they
    say."""
    from repro_torch.kernels import flash_attention as FA
    z = np.load(LM_TRAIN_FIXTURE)
    plain = FA.attention_plain
    FA.attention_plain = attention_kernel_rounding
    try:
        e = check_lm_train(arch, *lm_train_step(z, arch, "cpu"),
                           tol=LM_TRAIN_CARD_TOL[arch])
    finally:
        FA.attention_plain = plain
    got = (e["grad"], e["grad_norm"], e["far"], e["aux"],
           *rounding_shift(z, arch))
    want = (*LM_TRAIN_KERNEL_ROUNDING[arch], *LM_TRAIN_ROUNDING_SHIFT[arch])
    np.testing.assert_allclose(got, want, rtol=0.1, atol=1e-3)


@pytest.mark.parametrize("arch", LM_TRAIN_FP32_ARCHS)
def test_fp32_gradients_equal_fixture(arch):
    """The port's fp32 gradient on the CPU against the JAX package's fp32
    gradient in the fixture (``grad32``, what the card's fp32 step is held
    to in ``chip_smoke.py`` phase 21 (c)), at ``LM_TRAIN_FP32_TOL``."""
    z = np.load(LM_TRAIN_FIXTURE)
    got, arrs = lm_train_fp32_grads(z, arch, "cpu")
    check_lm_train_fp32(arch, got, arrs, LM_TRAIN_FP32_TOL[arch])


def test_fp32_gradients_equal_jax():
    """The algorithm, without bf16: both packages' gradients of the
    reduced recurrentgemma (the config whose bf16 gradient says least) at
    the fixture's parameters cast to fp32, on the fixture's whole batch
    (80 positions, past its reduced window of 64, so the window binds),
    agree within 5e-3 in relative L2 per leaf (its RG-LRU scans in another
    order; the reduced Llama's agree within 1e-5)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_arch
    from repro.models import Batch as JBatch
    from repro.train.step import loss_fn as jax_loss_fn
    from repro_torch.models.model import Batch
    from repro_torch.train import loss_fn
    from torch_parity import lm_train_params
    arch = "recurrentgemma-2b"
    z = np.load(LM_TRAIN_FIXTURE)
    cfg, params, batch, arrs = load_lm_train(z, arch, "cpu")
    full = {k: arrs[k] for k in ("tokens", "positions", "labels")}
    assert full["tokens"].shape[1] > cfg.attn_window == 64
    jc = jax_arch(arch).reduced()
    jp = jax.tree.map(lambda a: jnp.asarray(_f32(a)),
                      convert.nest(lm_train_params(arch)))
    want = jax.jit(jax.grad(lambda p, b: jax_loss_fn(jc, p, b)[0]))(
        jp, JBatch(**{k: jnp.asarray(v) for k, v in full.items()}))
    p32 = params.float().requires_grad_(True)
    leaves = dict(p32.named_parameters())
    tot, _ = loss_fn(cfg, p32, Batch(**{k: torch.tensor(v)
                                        for k, v in full.items()}))
    grads = torch.autograd.grad(tot, list(leaves.values()))
    got = flatten(convert.named_to_numpy(dict(zip(leaves, grads)), cfg))
    for k, w in flatten(jax.tree.map(np.asarray, want)).items():
        assert _rel(got[k], w) <= 5e-3, k
