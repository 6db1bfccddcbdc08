"""The port's AdamW (``repro_torch.optim``) and synthetic data pipeline
(``repro_torch.data``) on the CPU against the JAX package.

AdamW: from the same bf16 gradients, parameters and moments (numpy from
a seed), ``adamw_update`` gives the reference's (jitted, as its train
step runs it) new parameters, ``m`` and ``v`` bit for bit except for at
most 2 elements in 1000 one bf16 ulp apart (the global norm sums the
leaves in another order, which moves the clip scale in its last bit);
``cosine_lr`` and ``global_norm`` within 1e-6 relative.

Data: the port draws from ``numpy.random.Generator(PCG64(SeedSequence((seed,
step, shard))))`` where the reference draws ``jax.random`` bits, so the
two streams differ; the transform (:func:`zipf_bigram_tokens`) fed the
uniforms and coin the reference draws from its own key equals the
reference's ``make_batch`` bit for bit, for a text and the audio config.
``make_batch`` is a pure function of ``(seed, step, shard)``, rolls the
audio stub's draws over the codebooks (the reference's quirk) and builds
M-RoPE positions ``(p, p // 7, p % 7)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch as jax_make_batch
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import OptState as JOptState
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import cosine_lr as jax_cosine_lr
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_batch, zipf_bigram_tokens
from repro_torch.models.layers import ParamDef, ParamTree
from repro_torch.optim import (AdamWConfig, OptState, adamw_update, cosine_lr,
                               global_norm)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"a": (64, 33), "b": (7,), "c": (3, 5, 11)}
#: elements allowed one bf16 ulp apart, per element compared
ULP_SHARE = 2e-3


def _bf16(a):
    """numpy fp32 -> (bf16 jnp array, bf16 tensor) of the same values."""
    h = np.asarray(a, np.float32).astype(jnp.bfloat16)   # nearest even
    j = jnp.asarray(h)
    bits = h.view(np.int16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


@pytest.mark.parametrize("step,gscale", [(0, 1.0), (5, 1e-3), (150, 50.0)])
def test_adamw_update_equals_reference(step, gscale):
    rng = np.random.default_rng(step)
    draw = lambda scale, absval=False: {
        k: _bf16((np.abs if absval else np.asarray)(
            rng.standard_normal(s) * scale).astype(np.float32))
        for k, s in SHAPES.items()}
    p, g, m, v = draw(0.1), draw(gscale), draw(0.01), draw(1e-2, True)
    v = {k: _bf16(np.square(np.asarray(x[0], np.float32)))
         for k, x in v.items()}
    first = lambda d: {k: x[0] for k, x in d.items()}
    second = lambda d: {k: x[1] for k, x in d.items()}
    # jitted, as the reference's train step runs it
    jp, jo, jm = jax.jit(jax_adamw_update, static_argnums=3)(
        first(g), first(p), JOptState(step=jnp.int32(step), m=first(m),
                                      v=first(v)), JAdamWConfig())
    tree = ParamTree({k: ParamDef(s, (None,) * len(s))
                      for k, s in SHAPES.items()}, "cpu")
    with torch.no_grad():
        for k in SHAPES:
            tree[k].copy_(p[k][1])
    pp, po, pm = adamw_update(
        second(g), tree, OptState(step=torch.tensor(step, dtype=torch.int32),
                                  m=second(m), v=second(v)), AdamWConfig())
    apart = total = 0
    for k in SHAPES:
        for a, b in ((jp[k], pp[k]), (jo.m[k], po.m[k]), (jo.v[k], po.v[k])):
            d = np.abs(_bits(a) - _bits(b))
            assert d.max() <= 1, k
            apart += int((d != 0).sum())
            total += d.size
    assert apart <= ULP_SHARE * total, (apart, total)
    assert int(po.step) == step + 1 and po.step.dtype == torch.int32
    np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert pp["a"].requires_grad == tree["a"].requires_grad


def test_cosine_lr_and_global_norm():
    for cfg in (dict(), dict(warmup_steps=1, total_steps=10),
                dict(lr=6e-4, warmup_steps=15, total_steps=300)):
        jc, pc = JAdamWConfig(**cfg), AdamWConfig(**cfg)
        for s in (0, 1, 7, 15, 99, 100, 101, 5000, 10_000, 20_000):
            want = float(jax_cosine_lr(jc, jnp.int32(s)))
            got = float(cosine_lr(pc, torch.tensor(s, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal(s).astype(np.float32) * 3
              for s in SHAPES.values()]
    want = float(jax_global_norm([jnp.asarray(x, jnp.bfloat16)
                                  for x in leaves]))
    got = float(global_norm([_bf16(x)[1] for x in leaves]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@jax.jit
def _draws(seed, step, like):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), step), 0)
    k1, k2, _ = jax.random.split(key, 3)
    return (jax.random.uniform(k1, like.shape, jnp.float32, 1e-6, 1.0),
            jax.random.bernoulli(k2, 0.5, like.shape))


def _reference_draws(cfg, dc, step, shape):
    """The uniforms and the coin the reference's ``make_batch`` draws
    (its key, split as it splits it)."""
    u, coin = _draws(dc.seed, step, jax.ShapeDtypeStruct(shape, jnp.uint8))
    return np.asarray(u), np.asarray(coin)


@pytest.mark.parametrize("arch,step", [("llama3.2-1b", 0),
                                       ("musicgen-medium", 3)])
def test_transform_equals_reference_on_its_draws(arch, step):
    jc = jax_arch(arch).reduced()
    dc = JDataConfig(seq_len=40, global_batch=3, seed=5)
    want = jax.jit(jax_make_batch, static_argnums=(0, 1, 2))(jc, dc, step)
    shape = (3, 41) + ((jc.n_codebooks,) if jc.frontend == "audio_stub"
                       else ())
    u, coin = _reference_draws(jc, dc, step, shape)
    toks = zipf_bigram_tokens(u, coin, jc.vocab, dc.zipf_a)
    np.testing.assert_array_equal(toks[:, :-1], np.asarray(want.tokens))
    np.testing.assert_array_equal(toks[:, 1:], np.asarray(want.labels))


def test_make_batch_is_a_function_of_seed_step_and_shard():
    cfg = get_arch("llama3.2-1b").reduced()
    dc = DataConfig(seq_len=16, global_batch=4, seed=1)
    a = make_batch(cfg, dc, 7, device="cpu")
    b = make_batch(cfg, dc, 7, device="cpu")
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    c = make_batch(cfg, dc, 8, device="cpu")
    d = make_batch(cfg, DataConfig(16, 4, seed=2), 7, device="cpu")
    s1 = make_batch(cfg, dc, 7, shard=1, n_shards=2, device="cpu")
    assert not torch.equal(a.tokens, c.tokens)
    assert not torch.equal(a.tokens, d.tokens)
    assert s1.tokens.shape == (2, 16) and not torch.equal(s1.tokens,
                                                          a.tokens[:2])
    assert a.tokens.dtype == torch.int32 and a.labels.dtype == torch.int32
    torch.testing.assert_close(a.tokens[:, 1:], a.labels[:, :-1])
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < cfg.vocab
    torch.testing.assert_close(a.positions, torch.arange(
        16, dtype=torch.int32)[None].repeat(4, 1))


def test_audio_roll_is_over_codebooks_and_mrope_positions():
    """The bigram successor of a codebook token is the previous codebook's
    at the same time step (the roll runs over the last axis, as in the
    reference); M-RoPE positions are ``(p, p // 7, p % 7)``, the vision
    stub's patch embeddings (b, T // 8, d) bf16."""
    cfg = get_arch("musicgen-medium").reduced()
    dc = DataConfig(seq_len=12, global_batch=2, seed=4)
    b = make_batch(cfg, dc, 0, device="cpu")
    K, V = cfg.n_codebooks, cfg.vocab
    assert b.tokens.shape == (2, 12, K) and b.labels.shape == (2, 12, K)
    u = np.full((1, 1, K), 0.5, np.float32)
    coin = np.zeros((1, 1, K), bool)
    base = zipf_bigram_tokens(u, coin, V, 1.3)
    coin[..., 1] = True
    rolled = zipf_bigram_tokens(u, coin, V, 1.3)
    assert rolled[0, 0, 1] == (base[0, 0, 0] * 31 + 7) % V
    qc = get_arch("qwen2-vl-72b").reduced()
    qb = make_batch(qc, DataConfig(seq_len=24, global_batch=2), 0,
                    device="cpu")
    p = torch.arange(24, dtype=torch.int32)
    torch.testing.assert_close(qb.positions[1], torch.stack(
        [p, p // 7, p % 7], -1))
    assert qb.vis_embeds.shape == (2, 3, qc.d_model)
    assert qb.vis_embeds.dtype == torch.bfloat16
    assert 0.01 < float(qb.vis_embeds.float().std()) < 0.03


def test_opt_state_and_batch_carry_over_from_the_reference():
    """``convert.opt_state`` turns the reference's ``OptState`` (numpy
    leaves, the nested and stacked layout) into the port's ``{name:
    tensor}`` moments and int32 step, and ``named_to_numpy`` takes them
    back, bit for bit; ``convert.batch`` carries a reference ``Batch``."""
    import jax.tree_util as jtu
    from repro.models import init_params as jax_init_params
    from repro.optim.adamw import adamw_init as jax_adamw_init
    from repro_torch import convert
    jc, pc = (jax_arch("llama3.2-1b").reduced(),
              get_arch("llama3.2-1b").reduced())
    # the parameter tree's shapes, traced, not computed
    jp = jax.eval_shape(lambda key: jax_init_params(jc, key),
                        jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    moment = lambda: jtu.tree_map(lambda a: rng.standard_normal(
        a.shape).astype(jnp.bfloat16), jp)
    st = jax.eval_shape(lambda p: jax_adamw_init(p, JAdamWConfig()),
                        jp)._replace(
        step=np.int32(7), m=moment(), v=moment())
    po = convert.opt_state(jtu.tree_map(np.asarray, st)._asdict(), pc,
                           "cpu")
    assert int(po.step) == 7 and po.step.dtype == torch.int32
    for ref, got in ((st.m, po.m), (st.v, po.v)):
        want = jtu.tree_leaves(jtu.tree_map(
            lambda a: np.asarray(a, np.float32), ref))
        back = jtu.tree_leaves(convert.named_to_numpy(got, pc))
        assert len(want) == len(back)
        for a, b in zip(want, back):
            np.testing.assert_array_equal(a, b)
    jb = jax.jit(jax_make_batch, static_argnums=(0, 1, 2))(
        jc, JDataConfig(seq_len=8, global_batch=2), 0)
    pb = convert.batch(jtu.tree_map(np.asarray, jb)._asdict(), "cpu")
    for k in ("tokens", "positions", "labels"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(jb, k)))
    assert pb.vis_embeds is None
