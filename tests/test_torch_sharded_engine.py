"""PyTorch port, the channel-sharded engine (``Simulator(channel_shard=d)``
over ``torch.distributed``) on ``gloo`` at 2 and 4 ranks, each rank a
process (``tests/torch_sharded_worker.py``), against the port's own
single-process run of the same sessions, bit for bit: ``Stats``, the
dense trace and telemetry (fast-forward on and off), the ``DDR4@2ch``
golden hash, and the DDR5x2 + CXL-DDR4x2 system.  The reference's own
sharded program fails on this tree (ROADMAP queue 3), so it is not the
yardstick.  Also: ``reshard_state`` over two meshes and a checkpoint of a
sharded state, and the single-process refusals (an explicit mesh with
one rank raises, the default stays unsharded)."""
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_sharded_worker as W                             # noqa: E402

GOLDEN = json.load(open(os.path.join(HERE, "trace", "golden_hashes.json")))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, tmp) -> tuple:
    """Start the worker's ``world`` gloo ranks: ``(processes, rank 0's
    output path)``."""
    out = os.path.join(tmp, f"world{world}.pkl")
    env = dict(os.environ, SHARD_TMP=str(tmp),
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(HERE, "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_sharded_worker.py"),
         str(r), str(world), str(port), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)], out


def _collect(procs, out) -> dict:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results and every session run unsharded here, the
    latter while the worlds run."""
    started = {}
    for w in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sharded{w}")
        started[w] = _launch(w, tmp)
    single = {name: fn(False) for name, (fn, _) in W.SESSIONS.items()}
    return {w: _collect(*started[w]) for w in started}, single


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


CASES = [(w, s) for w in (2, 4) for s in W.sessions_for(w)]


@pytest.mark.parametrize("world,session", CASES,
                         ids=[f"{w}ranks-{s}" for w, s in CASES])
def test_sharded_session_equals_single_device(worlds, single, world,
                                              session):
    _assert_same(worlds[world][session], single[session])


def test_sharded_golden_hash_ddr4_2ch(worlds):
    want = GOLDEN["DDR4@2ch"]
    got = worlds[2]["ddr4_2ch_golden"]
    assert (got["n"], got["sha256"]) == (want["n"], want["sha256"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_runs_are_cached_as_channel_meshes(worlds, world):
    assert worlds[world]["topologies"] == [f"channels:{world}"]


@pytest.mark.parametrize("world", (2, 4))
def test_only_an_explicit_request_shards(worlds, world):
    assert worlds[world]["resolved"] == {"None": None, "False": None,
                                         "True": world}


@pytest.mark.parametrize("world", [2, 4])
def test_reshard_state_roundtrip_over_two_meshes(worlds, world):
    r = worlds[world]["reshard"]
    assert r["placements_ok"] and r["sharded_somewhere"]
    assert r["equal"] and r["step"] == 7


def test_one_rank_refuses_an_explicit_mesh_and_auto_stays_unsharded():
    from repro_torch.core import Simulator
    from repro_torch.core import engine as E
    with pytest.raises(ValueError, match="process group"):
        Simulator(*W.DDR4, channels=2, device="cpu", channel_shard=2)
    with pytest.raises(ValueError, match="no usable channel mesh"):
        Simulator(*W.DDR4, channels=2, device="cpu", channel_shard=True)
    sim = Simulator(*W.DDR4, channels=2, device="cpu")
    assert sim._resolved_shard() is None
    assert E.auto_channel_shard(sim.msys, n_devices=2) == 2
    assert E.auto_channel_shard(sim.msys, n_devices=4) is None
    with pytest.raises(ValueError, match="divide"):
        E.make_run(sim.msys, sim.controller, sim.frontend, 10, False,
                   shard=3)
