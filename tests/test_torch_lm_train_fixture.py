"""``tests/torch_lm_train.npz`` is current: each of the ten reduced
configurations (``torch_parity.LM_TRAIN_ARCHS``) is run again by the JAX
package (its ``logits_and_loss``, the gradient of its ``loss_fn`` and one
jitted ``make_train_step``) and compared with the file: the batch, the
sampled gradient, new parameters and moments exactly, the loss, aux,
``grad_norm`` and ``lr`` at 1e-6 (the same program on the same CPU).  The
parameters are the serving fixtures' (``torch_parity.LM_TRAIN_PARAMS``),
whose currency tests hold them to the JAX package's
``init_params(PRNGKey(0))``.  ``chip_smoke.py`` phase 21 reads
the file on the card, which has no JAX; write it anew with

    PYTHONPATH=src python tests/torch_parity.py --write-lm-train-fixture
"""
import numpy as np
import pytest

from torch_parity import LM_TRAIN_ARCHS, LM_TRAIN_FIXTURE, lm_train_arrays
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

SCALARS = ("loss", "aux", "grad_norm", "lr")


def test_fixture_holds_every_arch():
    z = np.load(LM_TRAIN_FIXTURE)
    assert sorted({k.split("@")[0] for k in z.files}) == \
        sorted(LM_TRAIN_ARCHS)


@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_lm_train_fixture_is_current(arch):
    fresh = lm_train_arrays(arch)
    z = np.load(LM_TRAIN_FIXTURE)
    assert sorted(k for k in z.files if k.startswith(f"{arch}@")) == \
        sorted(fresh)
    for k, v in fresh.items():
        if k.split("@")[1] in SCALARS:
            np.testing.assert_allclose(z[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(z[k], v, err_msg=k)
