"""The port's LM serving path (``repro_torch.models``, ``repro_torch.
serve``) against the JAX package on the CPU: configuration, parameter
shapes and count at full width (from shapes, nothing allocated), the
parameter hand-over, prefill and teacher-forced decode logits, greedy
``serve_batch`` tokens, and the fixture ``tests/torch_serve_fixture.npz``
that ``chip_smoke.py`` holds the port to on the card.

Logits are compared at ``LOGITS_TOL`` (atol 0.2, rtol 0.05), the JAX
package's own decode-parity tolerance; greedy tokens exactly."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Batch as JBatch
from repro.models import decode_step as jax_decode_step
from repro.models import param_defs as jax_param_defs
from repro.models.model import count_params as jax_count_params
from repro.serve.step import make_prefill_step as jax_prefill_step
from repro.serve.step import serve_batch as jax_serve_batch
from repro_torch import convert
from repro_torch.configs import ModelConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.models.layers import ParamTree
from repro_torch.serve.step import make_prefill_step, serve_batch
from torch_parity import (LOGITS_TOL, SERVE_FIXTURE, flatten, lm_configs,
                          lm_pair, prompts, serve_fixture_arrays, tree_np)

LLAMA_1B_PARAMS = 1_235_814_400
VARIANTS = ["reduced", "gqa"]


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    return lm_pair(request.param, seed=2)


def test_config_fields_equal():
    for variant in ("full", "reduced", "gqa"):
        jc, pc = lm_configs(variant)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc), variant
    jc, pc = lm_configs("full")
    assert (pc.n_layers, pc.d_model, pc.n_heads, pc.n_kv_heads, pc.head_dim,
            pc.d_ff, pc.vocab, pc.tie_embeddings) == \
        (16, 2048, 32, 8, 64, 8192, 128_256, True)


def test_full_width_param_shapes_and_count():
    jc, pc = lm_configs("full")
    want = {}
    for path, d in flatten(jax_param_defs(jc)).items():
        top, *rest = path.split(".")
        if top == "groups":                  # stacked: (layers, ...)
            for i in range(d.shape[0]):
                want[".".join(["layers", str(i)] + rest[1:])] = d.shape[1:]
        else:
            want[path] = d.shape
    module = ParamTree(M.param_defs(pc), device="meta")   # no storage
    got = {k: tuple(v.shape) for k, v in module.named_parameters()}
    assert got == want
    assert all(p.dtype == torch.bfloat16 for p in module.parameters())
    assert sum(p.numel() for p in module.parameters()) == LLAMA_1B_PARAMS
    assert M.count_params(pc) == pc.param_count() == LLAMA_1B_PARAMS
    assert jax_count_params(jc) == LLAMA_1B_PARAMS


def test_convert_round_trip():
    jc, jp, pc, pp = lm_pair("gqa", seed=3)
    want = {k: np.asarray(v).view(np.uint16)
            for k, v in flatten(tree_np(jp)).items()}
    got = flatten(convert.lm_params_to_numpy(pp, pc))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the same tree as uint16 bits (the fixture's form)
    again = convert.lm_params(convert.lm_params_to_numpy(pp, pc), pc, "cpu")
    for (n, a), (_, b) in zip(pp.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n
    with pytest.raises(TypeError):
        convert.bf16_tensor(np.float32([0.5]), "cpu")


def _jax_prefill_and_decode(jc, jp, pr, seq, n):
    """JAX prefill logits and the teacher-forced decode logits of ``n``
    steps feeding ``seq[:, i]`` at position T + i."""
    B, T = pr.shape
    pos = jnp.arange(T, dtype=jnp.int32)[None].repeat(B, 0)
    lg, cache = jax_prefill_step(jc, T + n)(
        jp, JBatch(tokens=jnp.asarray(pr), positions=pos))
    out = [np.asarray(lg[:, -1])]
    for i in range(n):
        lg, cache = jax_decode_step(jc, jp, cache, JBatch(
            tokens=jnp.asarray(seq[:, i:i + 1]),
            positions=jnp.full((B, 1), T + i, jnp.int32),
            cache_index=jnp.int32(T + i), cache_len=jnp.int32(T + i + 1)))
        out.append(np.asarray(lg[:, -1]))
    return out


def _port_prefill_and_decode(pc, pp, pr, seq, n):
    B, T = pr.shape
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    lg, cache = make_prefill_step(pc, T + n)(
        pp, M.Batch(tokens=torch.tensor(pr), positions=pos))
    out = [lg[:, -1].numpy()]
    for i in range(n):
        lg, cache = M.decode_step(pc, pp, cache, M.Batch(
            tokens=torch.tensor(seq[:, i:i + 1]),
            positions=torch.full((B, 1), T + i, dtype=torch.int32),
            cache_index=T + i, cache_len=T + i + 1))
        out.append(lg[:, -1].numpy())
    return out


def test_prefill_and_decode_logits_match_jax(pair):
    jc, jp, pc, pp = pair
    pr = prompts(jc, 2, 20, seed=4)
    seq = prompts(jc, 2, 5, seed=5)          # teacher-forced tokens
    want = _jax_prefill_and_decode(jc, jp, pr, seq, 5)
    got = _port_prefill_and_decode(pc, pp, pr, seq, 5)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (2, jc.vocab) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **LOGITS_TOL)


def test_serve_batch_tokens_match_jax(pair):
    jc, jp, pc, pp = pair
    pr = prompts(jc, 2, 16, seed=6)
    jt, jf = jax_serve_batch(jc, jp, jnp.asarray(pr), 6)
    timings = {}
    pt, pf = serve_batch(pc, pp, pr, 6, device="cpu", timings=timings)
    assert pt.shape == (2, 6) and pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert set(timings) == {"prefill_s", "decode_s"}


def test_decode_matches_forward():
    """The port alone: prefill(T) + decode(token T) == forward over T+1."""
    _, _, pc, pp = lm_pair("gqa", seed=7)
    B, T = 2, 16
    toks = torch.tensor(prompts(pc, B, T + 1, seed=8))
    pos = torch.arange(T + 1, dtype=torch.int32)[None].repeat(B, 1)
    x, _ = M.forward(pc, pp, M.Batch(tokens=toks, positions=pos))
    want = M.last_logits(pc, pp, x)
    x2, _, states = M.forward(pc, pp, M.Batch(tokens=toks[:, :T],
                                              positions=pos[:, :T]),
                              return_states=True, cache_len=T + 4)
    got, _ = M.decode_step(pc, pp, states, M.Batch(
        tokens=toks[:, T:], positions=pos[:, T:], cache_index=T,
        cache_len=T + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)


def test_entry_points_need_a_card_unless_told_cpu():
    _, pc = lm_configs("reduced")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cpu"):
        M.init_params(pc, 0)
    pp = M.init_params(pc, 0, device="cpu")
    with pytest.raises(RuntimeError, match="cpu"):
        serve_batch(pc, pp, np.zeros((1, 4), np.int32), 2)
    with pytest.raises(RuntimeError, match="cpu"):
        launch_serve.main(["--arch", "llama3.2-1b", "--reduced"])


def test_launch_serve_cli_on_cpu(capsys):
    toks = launch_serve.main(["--arch", "llama3.2-1b", "--reduced",
                              "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--max-new", "3"])
    assert toks.shape == (2, 3)
    assert "arch=llama3.2-1b-reduced" in capsys.readouterr().out


def _load_fixture():
    z = np.load(SERVE_FIXTURE)
    cfg = json.loads(str(z["config"]))
    cfg["block_pattern"] = tuple(cfg["block_pattern"])
    pc = ModelConfig(**cfg)
    params = convert.lm_params(convert.nest(
        {k[len("param."):]: z[k] for k in z.files if k.startswith("param.")}),
        pc, "cpu")
    return z, pc, params


def test_port_matches_serve_fixture():
    """What chip_smoke.py checks on the card, here on the CPU."""
    z, pc, pp = _load_fixture()
    assert dataclasses.asdict(pc) == dataclasses.asdict(lm_configs("gqa")[1])
    pr = z["prompts"]
    toks, first = serve_batch(pc, pp, pr, z["tokens"].shape[1], device="cpu")
    np.testing.assert_array_equal(toks.numpy(), z["tokens"])
    np.testing.assert_array_equal(first.numpy(), z["first"])
    seq = np.concatenate([z["first"][:, None], z["tokens"]], 1)
    got = _port_prefill_and_decode(pc, pp, pr, seq, z["tokens"].shape[1])
    np.testing.assert_allclose(got[0], z["prefill_logits"], **LOGITS_TOL)
    np.testing.assert_allclose(np.stack(got[1:], 1), z["decode_logits"],
                               **LOGITS_TOL)


def test_serve_fixture_is_current():
    """Regenerates the fixture with the JAX package (write it anew with
    ``python tests/torch_parity.py --write-serve-fixture``)."""
    fresh = serve_fixture_arrays()
    z = np.load(SERVE_FIXTURE)
    assert sorted(z.files) == sorted(fresh)
    for k, v in fresh.items():
        if k.endswith("_logits"):
            np.testing.assert_allclose(z[k], v, atol=1e-6, rtol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_fresh_import_of_serving_path_leaves_jax_unloaded():
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import repro_torch.configs, repro_torch.models, repro_torch.serve\n"
            "import repro_torch.launch.serve, repro_torch.convert\n"
            "import repro_torch.kernels.flash_attention\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
