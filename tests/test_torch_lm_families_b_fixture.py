"""``tests/torch_lm_families_b.npz`` is current: each entry (the reduced
phi3.5-moe, phi3.5-moe at capacity 1.0, llama4-maverick, qwen2-vl-72b with
a ``vis_embeds`` forward, musicgen-medium, xlstm-350m and llama3.2-1b
with the int8 KV cache; ``torch_parity.LM_FAMILIES_B``) is served again
by the JAX package and compared with the file: parameters, prompts and
tokens exactly, logits at 1e-6 (the same program on the same CPU).
``chip_smoke.py`` phase 20 reads the file on the card, which has no JAX;
write it anew with

    PYTHONPATH=src python tests/torch_parity.py --write-lm-families-b-fixture

Also the registry: the port's ten configs are the reference's, field for
field, with its parameter counts and dry-run cells, and the serving CLI
runs each reduced one on the CPU.
"""
import dataclasses

import numpy as np
import pytest

from torch_parity import (LM_FAMILIES_B, LM_FAMILIES_B_FIXTURE,
                          lm_family_b_arrays)

ARCHS = ("llama3.2-1b", "qwen3-4b", "qwen3-14b", "glm4-9b",
         "recurrentgemma-2b", "phi3.5-moe-42b-a6.6b",
         "llama4-maverick-400b-a17b", "qwen2-vl-72b", "musicgen-medium",
         "xlstm-350m")


def test_fixture_holds_every_entry():
    z = np.load(LM_FAMILIES_B_FIXTURE)
    assert sorted({k.split("@")[0] for k in z.files}) == sorted(LM_FAMILIES_B)


@pytest.mark.parametrize("entry", list(LM_FAMILIES_B))
def test_families_b_fixture_is_current(entry):
    fresh = lm_family_b_arrays(entry)
    z = np.load(LM_FAMILIES_B_FIXTURE)
    assert sorted(k for k in z.files if k.startswith(f"{entry}@")) == \
        sorted(fresh)
    for k, v in fresh.items():
        if k.endswith("_logits"):
            np.testing.assert_allclose(z[k], v, atol=1e-6, rtol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_registry_is_the_references():
    """``all_archs()`` holds the reference's ten configs, field for field
    (a MoE config's too), with the same total and active parameter counts
    and the same ``valid_cells()``."""
    from repro.configs import all_archs as jax_archs
    from repro.configs import valid_cells as jax_cells
    from repro_torch.configs import all_archs, valid_cells
    got, want = all_archs(), jax_archs()
    assert sorted(got) == sorted(want) == sorted(ARCHS)
    for name in ARCHS:
        g, w = got[name], want[name]
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.param_count(), g.active_param_count()) == \
            (w.param_count(), w.active_param_count())
        assert dataclasses.asdict(g.reduced()) == \
            dataclasses.asdict(w.reduced())
    assert valid_cells() == jax_cells()


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_reduced_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <name> --reduced
    --device cpu`` serves every config."""
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.run(["--arch", arch, "--reduced", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "9",
                            "--max-new", "2"])
    K = (out["cfg"].n_codebooks,) \
        if out["cfg"].frontend == "audio_stub" else ()
    assert tuple(out["tokens"].shape) == (2, 2) + K
    assert f"arch={arch}-reduced" in capsys.readouterr().out
