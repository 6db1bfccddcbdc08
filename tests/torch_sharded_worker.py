"""One rank of the channel-sharded engine tests
(``tests/test_torch_sharded_engine.py``): it joins a ``gloo`` process
group of ``world`` ranks, runs every session that divides over the group
with ``channel_shard=world``, and rank 0 pickles the results (flattened to
numpy) to ``out``.  The test runs the same sessions unsharded in its own
process and compares.

    python tests/torch_sharded_worker.py RANK WORLD PORT OUT [SESSIONS]

``SESSIONS`` (comma-separated) picks sessions and skips the resharding
check.
"""
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
HETERO = [dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
               timing_preset="DDR5_4800B", channels=2),
          dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
               timing_preset="DDR4_2400R", channels=2, link_latency=80)]


def flatten(obj, prefix="") -> dict:
    """``{path: numpy array or scalar}`` of stats, traces, telemetry."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj.detach().cpu().numpy()}
    if dataclasses.is_dataclass(obj):
        obj = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
               if f.name != "meta"}
    elif hasattr(obj, "_fields"):
        obj = obj._asdict()
    elif isinstance(obj, (tuple, list)):
        obj = dict(enumerate(obj))
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(obj)}


def session_ddr4_4ch(shard, ff=True, device="cpu"):
    """DDR4 over 4 channels: stats, the dense trace and 250-cycle
    telemetry windows."""
    from repro_torch.core import Simulator
    sim = Simulator(*DDR4, channels=4, device=device, channel_shard=shard,
                    fast_forward=ff)
    stats, dense, telem = sim.run(600, interval=2.0, read_ratio=0.7,
                                  trace=True, telemetry=250)
    return {"stats": stats.to_dict(), **flatten(dense, "trace"),
            **flatten(telem, "telemetry"),
            "host_syncs": sim.host_syncs}


def session_ddr4_2ch_golden(shard):
    """The ``DDR4@2ch`` golden configuration: its command stream's
    sha256."""
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.trace import capture, trace_sha256
    sim = Simulator(*DDR4, channels=2, mapper="RoBaRaCoCh", device="cpu",
                    channel_shard=shard,
                    controller=ControllerConfig(refresh_stagger=False))
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    tr = capture(sim.cspec, dense)
    return {"stats": stats.to_dict(), "n": len(tr),
            "sha256": trace_sha256(tr)}


def session_hetero(shard):
    """DDR5x2 + CXL-DDR4x2@80: both groups split over 2 ranks."""
    from repro_torch.core import Simulator, compile_system
    sim = Simulator(system=compile_system(HETERO), device="cpu",
                    channel_shard=shard)
    stats, dense = sim.run(800, interval=2.0, read_ratio=0.7, trace=True)
    return {"stats": stats.to_dict(), **flatten(stats.per_group, "groups"),
            **flatten(dense, "trace")}


def session_per_cycle(shard):
    """The per-cycle loop (fast-forward off) over 4 channels."""
    return session_ddr4_4ch(shard, ff=False)


#: session -> the world sizes it runs at (each divides every group's
#: channel count; the 4-channel sessions at 2 ranks and the fast-forward
#: one at 4 too)
SESSIONS = {
    "ddr4_4ch": (session_ddr4_4ch, (2, 4)),
    "per_cycle": (session_per_cycle, (2,)),
    "ddr4_2ch_golden": (session_ddr4_2ch_golden, (2,)),
    "hetero": (session_hetero, (2,)),
}


def sessions_for(world: int) -> list:
    return [name for name, (_, worlds) in SESSIONS.items()
            if world in worlds]


def reshard_roundtrip():
    """A small train state placed on a (1, W) mesh by the default rules,
    moved to a (W, 1) mesh by the FSDP rules, and back; checkpointed
    from the second mesh and restored like the first: every leaf whole
    equals the start, and the placements are the rules'."""
    from repro_torch.checkpoint import reshard_state
    from repro_torch.checkpoint.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models.model import init_params
    from repro_torch.sharding import FSDP_RULES
    world = dist.get_world_size()
    cfg = get_arch("llama3.2-1b").reduced()
    params = init_params(cfg, seed=3, device="cpu")
    mesh_a = make_mesh((1, world), ("data", "model"), "cpu")
    mesh_b = make_mesh((world, 1), ("data", "model"), "cpu")
    sh_a = param_shardings(cfg, mesh_a)
    sh_b = param_shardings(cfg, mesh_b, FSDP_RULES)
    pa = reshard_state(params, sh_a)
    pb = reshard_state(pa, sh_b)
    back = reshard_state(pb, sh_a)
    out = {"placements_ok": all(
        tuple(p.placements) == sh_b[n].placements
        for n, p in pb.named_parameters())}
    # every rank gathers the leaves; each writes its own copy
    path = os.path.join(os.environ["SHARD_TMP"], f"ckpt{dist.get_rank()}")
    save_checkpoint(path, 7, pb)
    restored, man = load_checkpoint(path, like=pa)
    whole = {n: reshard_state(t, "cpu") for n, t in
             (("start", params), ("back", back), ("restored", restored))}
    out["equal"] = all(
        torch.equal(a, b) and torch.equal(a, c)
        for (_, a), (_, b), (_, c) in zip(
            whole["start"].named_parameters(),
            whole["back"].named_parameters(),
            whole["restored"].named_parameters()))
    out["sharded_somewhere"] = any(
        any(pl.is_shard() for pl in p.placements)
        for _, p in pb.named_parameters())
    out["step"] = man["step"]
    return out


def main(rank: int, world: int, port: int, out: str, only=None):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.core import engine as E
        names = only or sessions_for(world)
        res = {name: SESSIONS[name][0](world) for name in names}
        res["topologies"] = list(E.RUN_CACHE.stats()["shard_topologies"])
        # the group alone shards nothing; True asks for the whole group
        from repro_torch.core import Simulator
        res["resolved"] = {
            str(cs): Simulator(*DDR4, channels=4, device="cpu",
                               channel_shard=cs)._resolved_shard()
            for cs in (None, False, True)}
        if only is None:
            res["reshard"] = reshard_roundtrip()
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5].split(",") if len(sys.argv) > 5 else None)
