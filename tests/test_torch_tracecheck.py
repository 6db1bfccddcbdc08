"""PyTorch port, host-sync lint (``repro_torch.analysis.tracecheck``):
each rule on a synthetic cycle loop, suppression syntax, hot-context
discovery, the clean-tree gate over the real port and the ``analysis
trace`` CLI (the cases of the reference's ``tests/analysis/
test_tracecheck.py``, on the port's loop instead of ``lax.scan``)."""
import json
import os
import textwrap

import pytest

from repro_torch.analysis.__main__ import main
from repro_torch.analysis.tracecheck import (ContextIndex, lint_package,
                                             lint_paths, load_modules,
                                             package_dir)

PORT = package_dir()
SRC = os.path.dirname(PORT)

#: the port's per-line suppressions: (file in the package, rules, a piece
#: of the line); CHANGES.md lists the same
SUPPRESSED = {
    ("core/engine.py", "ts102", "both.tolist()"),
    ("core/controller.py", "ts102", "x.tolist()"),
    ("models/blocks.py", "ts101", '"mlp" in p'),
    ("models/blocks.py", "ts102", "float(torch.tensor(v, dtype=dtype))"),
}

#: a cycle loop as the engine has it: ``make_run``'s nested ``run`` in a
#: ``core/engine.py``, the hot loop the linter declares
LOOP = """
    import torch

    from pkg.core import ops


    def make_run(n_cycles: int):
        def run(state, value):
            at = [0]
            while True:
                if at[0] >= n_cycles:
                    break
                state = ops.step(state, at[0], value)
                t = at[0] + 1
                # the engine's one sync: host lists afterwards
                busy, h = torch.stack(  # lint: ignore[ts102]
                    [state.sum(), state.amax()]).tolist()
                target = min(t if busy else max(h, t), n_cycles)
                at[0] = target
            tail = state.cpu()              # after the loop: not hot
            return state, tail
        return run
"""

BAD = """
    import numpy as np
    import torch


    def step(state, clk: int, value):
        if state.sum() > 0:                 # TS101
            state = state - 1
        n = int(state[0])                   # TS102
        v = state.amax().item()             # TS102
        h = np.tanh(state)                  # TS103
        c = state.cpu()                     # TS103
        state = state.masked_fill(state > 3, value)   # TS106
        idx = state.nonzero()               # TS106
        ok = 0 if value is None else 1      # identity test
        m = len(state) + state.shape[0] + state.dim()  # metadata
        if clk % 7 == 0 and state.dtype == torch.int32:  # host values
            state = state + 1
        return state + n + v + ok + m + idx.numel() + h.size + c.numel()
"""

#: one violation of each rule, for the CLI's exit code
RULE_CASES = {
    "TS101": """
        def step(state, clk: int, value):
            return state if state.any() else value
    """,
    "TS102": """
        def step(state, clk: int, value):
            return state + float(value)
    """,
    "TS103": """
        def step(state, clk: int, value):
            return state + value.to("cpu")
    """,
    "TS104": """
        _KNOBS = [1, 2, 3]


        def step(state, clk: int, value):
            return state


        def configure(cfg_cls):
            return cfg_cls(extra_predicates=(
                lambda cspec, ctx: _KNOBS,))
    """,
    "TS105": """
        import jax.numpy as jnp


        def step(state, clk: int, value):
            return state
    """,
    "TS106": """
        def step(state, clk: int, value):
            return state.repeat_interleave(value)
    """,
}


def _write_pkg(tmp_path, ops, name="pkg", loop=LOOP):
    root = tmp_path / name
    core = root / "core"
    core.mkdir(parents=True)
    for d in (root, core):
        (d / "__init__.py").write_text("")
    (core / "engine.py").write_text(
        textwrap.dedent(loop).replace("pkg.core", f"{name}.core"))
    (core / "ops.py").write_text(textwrap.dedent(ops))
    return str(root)


def test_rules_fire_on_synthetic_cycle_loop(tmp_path):
    rep = lint_paths([_write_pkg(tmp_path, BAD)])
    assert rep.rules_fired() == {"TS101": 1, "TS102": 2, "TS103": 2,
                                 "TS106": 2}, rep.summary()
    assert {f.line for f in rep.findings if f.rule == "TS101"} == {7}
    assert not rep.ok()


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_cli_exits_1_on_each_rule(rule, tmp_path, capsys):
    pkg = _write_pkg(tmp_path, RULE_CASES[rule])
    assert main(["trace", pkg]) == 1
    out = capsys.readouterr().out
    assert f"[{rule}]" in out and "host-sync lint: FAILED" in out
    assert lint_paths([pkg]).rules_fired() == {rule: 1}


def test_ts101_forms(tmp_path):
    src = """
        def step(state, clk: int, value):
            x = state if state.any() else value      # ternary
            assert (state > 0).all()                 # assert
            y = state.any() and value                # and
            z = not state.all()                      # not
            while state.sum() > 0:                   # while
                state = state - 1
            w = [v for v in value if v > 0]          # comprehension if
            if clk > 3 and value is not None:        # host: no finding
                state = state + 1
            return state, x, y, z, w
    """
    rep = lint_paths([_write_pkg(tmp_path, src)])
    assert rep.rules_fired() == {"TS101": 6}, rep.summary()


def test_masked_fill_with_tensor_value_fires_and_host_value_does_not(
        tmp_path):
    # the queue_insert case: a 0-d tensor value syncs, torch.where does not
    src = """
        import torch


        def step(state, clk: int, value):
            hit = state == 0
            a = state.masked_fill(hit, value)           # TS106
            b = state.masked_fill(hit, clk)             # a host int
            c = state.masked_fill(hit, 7)
            d = torch.where(hit, value, state)
            e = state.index_fill(0, hit.long(), value)  # TS106
            f = torch.where(hit)                        # TS106
            g = torch.where(hit, 1, 0)
            return a + b + c + d + e + g, f
    """
    rep = lint_paths([_write_pkg(tmp_path, src)])
    assert rep.rules_fired() == {"TS106": 3}, rep.summary()


def test_isinstance_narrowing(tmp_path):
    # controller.queue_insert's `put`: the else branch holds a host value
    src = """
        import torch


        def put(a, hit, v):
            if isinstance(v, torch.Tensor):
                return torch.where(hit, v, a)
            return a.masked_fill(hit, v)


        def put2(a, hit, v):
            return (torch.where(hit, v, a) if isinstance(v, torch.Tensor)
                    else a.masked_fill(hit, v))


        def host(x):
            return x if not isinstance(x, torch.Tensor) else x.tolist()


        def step(state, clk: int, value):
            s = put(state, state == 0, value)
            s = put2(s, state == 1, value)
            return s, host(value)
    """
    rep = lint_paths([_write_pkg(tmp_path, src)])
    # only the narrowed tensor's .tolist() is left
    assert rep.rules_fired() == {"TS102": 1}, rep.summary()
    assert "x.tolist()" in open(rep.findings[0].path).read().splitlines()[
        rep.findings[0].line - 1]


def test_host_annotations_and_fields(tmp_path):
    src = """
        from typing import NamedTuple

        import torch


        class Params(NamedTuple):
            lat: torch.Tensor
            nREFI: int


        class Config:
            def __init__(self, depth):
                self.depth = int(depth)
                self.table = torch.zeros(depth)


        def step(state, clk: int, value, dp: Params, cfg: Config,
                 flag: bool = False):
            if dp.nREFI and clk % dp.nREFI == 0:     # host fields
                state = state + 1
            if cfg.depth > 2 or flag:                # host field and param
                state = state - 1
            if dp.lat.sum() > 0:                     # TS101: a tensor field
                state = state * 2
            if cfg.table.any():                      # TS101: __init__ tensor
                state = state * 3
            return state
    """
    rep = lint_paths([_write_pkg(tmp_path, src)])
    assert rep.rules_fired() == {"TS101": 2}, rep.summary()


def test_unreached_function_and_post_loop_code_are_not_hot(tmp_path):
    # the same anti-patterns in a function the loop never calls, and a
    # .cpu() after the loop: no finding
    src = textwrap.dedent(BAD).replace("def step(", "def unused(") + (
        "\n\ndef step(state, clk: int, value):\n    return state\n")
    pkg = _write_pkg(tmp_path, src)
    rep = lint_paths([pkg])
    assert rep.findings == []
    ctxs = set(rep.meta["traced_contexts"])
    assert "pkg.core.ops:step" in ctxs
    assert "pkg.core.ops:unused" not in ctxs
    assert rep.meta["traced_contexts"][0] == "pkg.core.engine:make_run.run"


def test_transitive_callee_is_hot(tmp_path):
    src = """
        import torch


        def helper(q):
            v = torch.sum(q)
            return int(v)                   # TS102, reached through step


        def step(state, clk: int, value):
            fn = helper if clk else helper  # a local alias is followed
            return state + fn(state)
    """
    rep = lint_paths([_write_pkg(tmp_path, src)])
    assert rep.rules_fired() == {"TS102": 1}
    assert "pkg.core.ops:helper" in rep.meta["traced_contexts"]


def test_suppression_comment_and_skip_file(tmp_path):
    src = """
        def step(state, clk: int, value):
            if state.any():  # lint: ignore[ts101]
                pass
            n = int(state)                  # still flagged
            return state, n
    """
    rep = lint_paths([_write_pkg(tmp_path, src)])
    assert rep.rules_fired() == {"TS102": 1}   # suppression is per-rule
    assert sorted(s.rsplit("/", 1)[1] for s in rep.meta["suppressions"]) \
        == ["engine.py:16 [ts102]", "ops.py:3 [ts101]"]

    skip = "# lint: skip-file\n" + textwrap.dedent(src)
    rep2 = lint_paths([_write_pkg(tmp_path, skip, name="pkg2")])
    assert rep2.findings == []


def test_real_tree_contexts():
    mods = load_modules([PORT], root=SRC)
    idx = ContextIndex(mods)
    assert sorted(idx.roots) == [
        ("repro_torch.core.engine", "make_run.run"),
        ("repro_torch.train.step", "make_train_step.step")]
    assert len(idx.roots[("repro_torch.core.engine", "make_run.run")]) == 2
    ctxs = {f"{m}:{q}" for (m, q) in idx.contexts}
    for want in ("core.controller:controller_step",
                 "core.controller:step_and_horizon",
                 "core.controller:step_lanes_plain",
                 "core.controller:queue_insert",
                 "core.frontend:system_frontend_insert",
                 "core.frontend:arrival_horizon",
                 "core.frontend:idle_jump",
                 "core.device:issue",
                 "core.engine:make_run.run.cycle",
                 "core.engine:make_run.run.record",
                 "core.engine:make_run.run.snapshot",
                 "kernels.controller_step:controller_step_cuda"):
        assert "repro_torch." + want in ctxs, want
    for not_hot in ("core.engine:_aggregate_stats",
                    "core.engine:_dense_trace",
                    "core.engine:_unpack_snaps",
                    "core.engine:_gather_ranks",
                    "core.engine:_gather_trace",
                    "verify.explore:_Step.__call__"):
        assert "repro_torch." + not_hot not in ctxs, not_hot


def test_sharded_loop_and_training_step_are_hot():
    """The channel-sharded loop's two collectives sit in hot code (the
    sum in ``cycle``, the horizon's min in the loop), and the whole
    training step is a root: its callees down to the attention operators
    and AdamW are hot contexts."""
    import ast
    mods = load_modules([PORT], root=SRC)
    idx = ContextIndex(mods)
    ctxs = {f"{m}:{q}" for (m, q) in idx.contexts}
    for want in ("train.step:make_train_step.single",
                 "train.step:loss_fn",
                 "models.model:forward",
                 "models.model:logits_and_loss",
                 "models.blocks:block_apply",
                 "models.layers:flash_attention",
                 "kernels.flash_attention:_attend",
                 "optim.adamw:adamw_update",
                 "sharding.rules:settle"):
        assert "repro_torch." + want in ctxs, want
    eng = mods["repro_torch.core.engine"]
    loops = idx.roots[("repro_torch.core.engine", "make_run.run")]
    spans = [(n.lineno, n.end_lineno) for n in loops]
    cycle = eng.functions["make_run.run.cycle"]
    calls = [n for n in ast.walk(eng.tree) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "dist.all_reduce"]
    assert len(calls) == 2
    where = {("cycle" if cycle.lineno <= c.lineno <= cycle.end_lineno
              else "loop" if any(a <= c.lineno <= b for a, b in spans)
              else "cold") for c in calls}
    assert where == {"cycle", "loop"}


def test_port_tree_lints_clean_with_its_listed_suppressions():
    rep = lint_package()
    assert rep.ok(strict=True), rep.summary()
    got = set()
    for entry in rep.meta["suppressions"]:
        loc, rules = entry.rsplit(" ", 1)
        path, line = loc.rsplit(":", 1)
        text = open(path).read().splitlines()[int(line) - 1]
        rel = os.path.relpath(path, PORT).replace(os.sep, "/")
        for rule in rules.strip("[]").split(","):
            got.add((rel, rule, next(piece for r, ru, piece in SUPPRESSED
                                     if (r, ru) == (rel, rule)
                                     and piece in text)))
    assert got == SUPPRESSED


def test_cli_clean_tree_json_and_diff(tmp_path, capsys):
    out = str(tmp_path / "hs.json")
    assert main(["trace", "--show-contexts", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "host-sync lint: clean" in text
    assert "context: repro_torch.core.engine:make_run.run" in text
    doc = json.load(open(out))
    assert doc["counts"]["error"] == 0
    bad = str(tmp_path / "bad.json")
    assert main(["trace", _write_pkg(tmp_path, BAD), "--out", bad]) == 1
    capsys.readouterr()
    assert main(["diff", out, bad]) == 0
    assert "TS106" in capsys.readouterr().out


def test_repeat_interleave_by_tensor_repeats(tmp_path):
    src = """
        import torch


        def step(state, clk: int, value):
            a = state.repeat_interleave(3)                  # sizes known
            b = state.repeat_interleave(value)              # TS106
            c = state.repeat_interleave(value, output_size=8)
            d = torch.repeat_interleave(value)              # TS106
            e = torch.repeat_interleave(state, 2)
            return a, b, c, d, e
    """
    rep = lint_paths([_write_pkg(tmp_path, src)])
    assert rep.rules_fired() == {"TS106": 2}, rep.summary()


def test_plan_build_reads_nothing_back(monkeypatch):
    # the lint's finding on the port: the fused kernel's plan, built in
    # the loop's first iteration, read seven device tables back; it now
    # packs the host copies the tables were made from
    import numpy as np
    import torch

    import repro_torch.core.standards  # noqa: F401
    from repro_torch.core import controller as C
    from repro_torch.core import device as D
    from repro_torch.core.compile import compile_spec
    from repro_torch.kernels import controller_step as KS

    for std, org, tim in (("DDR5", "DDR5_16Gb_x8", "DDR5_4800B"),
                          ("HBM3", "HBM3_16Gb", "HBM3_5200")):
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, "cpu")
        cfg = C.ControllerConfig()

        def no_read(*a, **k):
            raise AssertionError("the plan read a tensor back")
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "cpu", no_read)
            m.setattr(torch.Tensor, "numpy", no_read)
            m.setattr(torch.Tensor, "tolist", no_read)
            plan = KS.build_plan(cspec, dp, cfg, 16, 2, "cpu", 1)
        tab = dp.tables
        np.testing.assert_array_equal(plan.table("Keys"),
                                      tab.ready.keys.numpy())
        np.testing.assert_array_equal(plan.table("A"), tab.ready.A.numpy())
        np.testing.assert_array_equal(plan.table("BankStride"),
                                      tab.bank_stride.numpy())
        np.testing.assert_array_equal(plan.table("NodeMul"),
                                      tab.node_mul.numpy())
        np.testing.assert_array_equal(plan.table("NodeOff"),
                                      tab.node_off.numpy())
        want = (tab.col_cmds.numpy().astype(np.int64)
                | (tab.row_cmds.numpy().astype(np.int64) << 1)
                if cspec.dual_command_bus else np.ones(cspec.n_cmds))
        np.testing.assert_array_equal(plan.table("Pass"), want)


def test_nested_callee_sees_enclosing_tensors(tmp_path):
    # the engine's loop calls closures of make_run's run (cycle, record,
    # snapshot): the tensors of the enclosing function are tensors there
    loop = LOOP.replace('''            at = [0]
''', '''            at = [0]
            buf = torch.zeros(4)

            def record(clk):
                if buf.any():               # TS101: an enclosing tensor
                    return clk
                return n_cycles             # a host value of make_run
''').replace('''                at[0] = target
''', '''                at[0] = target
                record(target)
''')
    rep = lint_paths([_write_pkg(tmp_path, "def step(state, clk: int, "
                                            "value):\n    return state\n",
                                 loop=loop)])
    assert rep.rules_fired() == {"TS101": 1}, rep.summary()
    assert "pkg.core.engine:make_run.run.record" in \
        rep.meta["traced_contexts"]


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_each_rule_is_silenced_by_its_suppression(rule, tmp_path):
    pkg = _write_pkg(tmp_path, RULE_CASES[rule])
    (hit,) = lint_paths([pkg]).findings
    lines = open(hit.path).read().splitlines()
    other = "ts101" if rule != "TS101" else "ts102"

    def lint_with(ids):
        changed = list(lines)
        changed[hit.line - 1] += f"  # lint: ignore[{ids}]"
        open(hit.path, "w").write("\n".join(changed) + "\n")
        return lint_paths([pkg])

    assert lint_with(other).rules_fired() == {rule: 1}    # per rule
    rep = lint_with(f"{other}, {rule.lower()}")
    assert rep.findings == [], rep.summary()
    assert len(rep.meta["suppressions"]) == 2       # the loop's and this
    open(hit.path, "w").write("# lint: skip-file\n"
                              + textwrap.dedent(RULE_CASES[rule]))
    assert lint_paths([pkg]).findings == []
