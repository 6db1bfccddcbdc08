"""PyTorch port, the dry run (``repro_torch.launch.dryrun``): one step of
a reduced llama3.2-1b (vocabulary 2048) as device 0 of a fake (2, 4)
("data", "model") mesh, in a subprocess with its own process group (as
``tests/launch/test_dryrun_small.py`` runs the reference's).  Checked:
FLOPs, collective bytes and ``temp_bytes`` above 0; a 4-way ``Shard``
matrix product counts a quarter of the global FLOPs and a replicated one
all of them; every layer group counts the same (3 groups - 2 groups == 2
groups - 1 group, what XLA's cost model needs probe lowerings for);
attention counts the causal pairs of its local shards; ``run_cell``
writes the reference's keys with the port's ``source``.  In this process:
meshes default to the card, and the flash entry points skip their
operators only where nothing could intercept them."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))

SCRIPT = r"""
import dataclasses, json, sys, tempfile
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig, register_arch
from repro_torch.kernels.flash_attention import attention_flops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((2, 4), ("data", "model"), "cpu")
out = {}

with FakeTensorMode() as fm:
    a = torch.empty(64, 128)
    b = torch.empty(128, 256)
    for name, pl in (("quarter", [Replicate(), Shard(0)]),
                     ("replicated", [Replicate(), Replicate()])):
        A = distribute_tensor(a, mesh, pl)
        B = distribute_tensor(b, mesh, [Replicate(), Replicate()])
        with D.counting(fm) as c:
            A @ B
        out[name] = c.flops
out["global_mm"] = 2 * 64 * 128 * 256

cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(), vocab=2048,
                          name="mini")
register_arch(cfg)
SHAPES["mini_train"] = ShapeConfig("mini_train", 64, 8, "train")
SHAPES["mini_prefill"] = ShapeConfig("mini_prefill", 64, 8, "prefill")
SHAPES["mini_decode"] = ShapeConfig("mini_decode", 64, 8, "decode")
for shape in ("mini_train", "mini_prefill", "mini_decode"):
    r = D.measure_cell(cfg, shape, mesh)
    out[shape] = {"flops": r["cost"]["flops"],
                  "bytes": r["cost"]["bytes_accessed"],
                  "temp": r["memory"]["temp_bytes"],
                  "coll": r["collectives"]["total_bytes"],
                  "kinds": sorted(r["collectives"]["by_kind"]),
                  "by_op": r["flops_by_op"]}
for n in (1, 2, 3):
    r = D.measure_cell(dataclasses.replace(cfg, n_layers=n), "mini_train",
                       mesh)
    out[f"groups{n}"] = r["cost"]["flops"]
# the local shards of prefill attention: batch 8 over data (2), the 2 q
# heads of the reduced model do not split 4 ways over model
out["attn_pairs"] = cfg.n_layers * attention_flops(
    (4, 64, 2, 32), (4, 64, 2, 32), 2, True, None)
with tempfile.TemporaryDirectory() as tmp:
    out["cell"] = D.run_cell("mini", "mini_prefill", False, out_dir=tmp,
                             force=True)
# a tensor off the host onto this CPU mesh is refused, not moved
from repro_torch.checkpoint import reshard_state
from repro_torch.sharding import NamedSharding
try:
    reshard_state(torch.zeros(4, device="meta"), NamedSharding(mesh, (None,)))
    out["refused"] = ""
except ValueError as e:
    out["refused"] = str(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dry():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_sharded_matmul_counts_the_local_share(dry):
    assert dry["quarter"] * 4 == dry["global_mm"]
    assert dry["replicated"] == dry["global_mm"]


@pytest.mark.parametrize("shape", ["mini_train", "mini_prefill",
                                   "mini_decode"])
def test_cells_count_work_collectives_and_memory(dry, shape):
    r = dry[shape]
    assert r["flops"] > 0 and r["bytes"] > 0 and r["temp"] > 0
    assert r["coll"] > 0, "no collectives on a 2x4 mesh?"
    assert r["kinds"] == ["all-gather", "all-reduce", "all-to-all",
                          "collective-permute", "reduce-scatter"]


def test_every_layer_group_counts_alike(dry):
    """An eager count runs every group: no probe lowerings needed."""
    g1, g2, g3 = dry["groups1"], dry["groups2"], dry["groups3"]
    assert g2 > g1 and g3 - g2 == g2 - g1


def test_attention_counts_the_causal_pairs(dry):
    assert dry["mini_prefill"]["by_op"]["repro_torch.flash_fwd"] \
        == dry["attn_pairs"]
    # training: each group's forward runs twice (recomputed for the
    # backward), the backward 10 D a pair against the forward's 4 D
    train = dry["mini_train"]["by_op"]
    assert train["repro_torch.flash_fwd_lse"] == 2 * dry["attn_pairs"]
    assert train["repro_torch.flash_bwd"] == dry["attn_pairs"] * 10 // 4


def test_run_cell_writes_the_reference_keys(dry):
    c = dry["cell"]
    assert c["source"] == "repro_torch eager count" and c["ok"]
    assert set(c["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes", "code_bytes"}
    assert set(c["cost"]) == {"flops", "bytes_accessed"}
    assert set(c["collectives"]) == {"total_bytes", "by_kind"}
    assert c["mesh"] == "16x16" and c["kind"] == "prefill"


def test_reshard_refuses_to_move_a_device_tensor_onto_a_cpu_mesh(dry):
    assert "onto a cpu mesh" in dry["refused"]


def test_meshes_default_to_the_card(monkeypatch):
    """Without CUDA a mesh raises unless the CPU is asked for (before any
    process group is started)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (M.make_host_mesh, M.make_production_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert not dist.is_initialized()


def _flash_inputs(seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((2, 16, h, 16)),
                         dtype=torch.float32, requires_grad=True)
            for h in (4, 2, 2)]


def test_entry_points_call_the_operator_bodies_only_when_nothing_intercepts():
    """Plain tensors with no dispatch mode skip the operators; the flop
    counter and fake tensors go through them; both give the same output
    and gradients, and the counter sees the operators."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs()
    assert FA._direct(q, k, v)
    runs = {}
    for name, mode in (("direct", None),
                       ("operators", FlopCounterMode(display=False))):
        for x in (q, k, v):
            x.grad = None
        if mode is None:
            out = FA.flash_attention_bthd(q, k, v, causal=True)
        else:
            with mode:
                assert not FA._direct(q, k, v)
                out = FA.flash_attention_bthd(q, k, v, causal=True)
                out.sum().backward()
        if mode is None:
            out.sum().backward()
        runs[name] = (out.detach(), *(x.grad.clone() for x in (q, k, v)))
    for a, b in zip(runs["direct"], runs["operators"]):
        assert torch.equal(a, b)
    flops = mode.get_flop_counts()["Global"]
    pairs = FA.visible_pairs(16, 16, True, None)
    assert flops[torch.ops.repro_torch.flash_fwd_lse] == 4 * 2 * 4 * 16 * pairs
    assert flops[torch.ops.repro_torch.flash_bwd] == 10 * 2 * 4 * 16 * pairs
    with FakeTensorMode():
        fq, fk, fv = (torch.empty(2, 16, h, 16) for h in (4, 2, 2))
        assert not FA._direct(fq, fk, fv)
        assert FA.flash_attention_bthd(fq, fk, fv).shape == (2, 16, 4, 16)
