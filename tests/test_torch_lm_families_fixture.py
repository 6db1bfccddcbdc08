"""``tests/torch_lm_families.npz`` is current: each arch's part is served
again by the JAX package (the reduced qwen3-4b, qwen3-14b, glm4-9b and
recurrentgemma-2b of ``torch_parity.LM_FAMILY_RUNS``) and compared with
the file: parameters, prompts and tokens exactly, logits at 1e-6 (the
same program on the same CPU).  ``chip_smoke.py`` phase 19 reads the file
on the card, which has no JAX; write it anew with

    PYTHONPATH=src python tests/torch_parity.py --write-lm-families-fixture
"""
import numpy as np
import pytest

from torch_parity import LM_FAMILIES, LM_FAMILIES_FIXTURE, lm_family_arrays


def test_fixture_holds_every_family():
    z = np.load(LM_FAMILIES_FIXTURE)
    assert sorted({k.split("@")[0] for k in z.files}) == sorted(LM_FAMILIES)


@pytest.mark.parametrize("name", LM_FAMILIES)
def test_families_fixture_is_current(name):
    fresh = lm_family_arrays(name)
    z = np.load(LM_FAMILIES_FIXTURE)
    assert sorted(k for k in z.files if k.startswith(f"{name}@")) == \
        sorted(fresh)
    for k, v in fresh.items():
        if k.endswith("_logits"):
            np.testing.assert_allclose(z[k], v, atol=1e-6, rtol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(z[k], v, err_msg=k)
