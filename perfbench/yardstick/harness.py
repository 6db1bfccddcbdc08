"""What a driver gets: the cell, its model and seed, the device, and the
measured window."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import time
from pathlib import Path

from yardstick import model as model_files
from yardstick import trace as tr

ROOT = Path(__file__).resolve().parents[1]


def load_json(*parts) -> dict:
    return json.loads(ROOT.joinpath(*parts).read_text())


@dataclasses.dataclass
class Cell:
    """One workload: ``BENCHMARK.json``'s entry, its traffic file and its
    own file (the limits of its comparison)."""
    name: str
    config: str
    chips: int
    traffic: dict
    own: dict

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return cls(name=name, config=entry["config"],
                   chips=int(entry["chips"]),
                   traffic=load_json("traffic", f"{entry['traffic']}.json"),
                   own=load_json("workloads", f"{name}.json"))


class Window:
    """The measured window: ``over()`` says when ``seconds`` have passed on
    the host's clock; the window closes once the device has finished."""

    def __init__(self, seconds: float):
        self.seconds_asked = seconds
        self.t0 = self.t1 = None

    def over(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds_asked

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: object
    t_start: float
    model: model_files.Dense = None
    setup_s: float = None
    peak_bytes: int = None
    trace: tr.Trace = None
    window_s: float = None
    marks: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.model is None:
            self.model = model_files.load(self.cell.config)

    def reference(self):
        """The plain reference that the configuration file names
        (``reference/<name>.py``)."""
        return importlib.import_module(f"reference.{self.model.reference}")

    def mark(self, label: str):
        """Note the seconds since the start at a step of set-up (printed
        on standard error with the run's timings)."""
        self.sync()
        self.marks.append((label, time.perf_counter() - self.t_start))

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_peak(self) -> int:
        import torch
        if self.device.type == "cuda":
            return torch.cuda.max_memory_allocated(self.device)
        return 0

    @contextlib.contextmanager
    def window(self):
        """Set-up ends where this opens (the device idle); inside, the
        driver's loop; on close, the device is waited for, the window's
        length and the memory peak over set-up and window are read, and a
        traced run's profile is reduced."""
        self.sync()
        prof = tr.profiler() if self.traced else contextlib.nullcontext()
        win = Window(self.seconds)
        with prof:
            with tr.window_span():
                win.t0 = time.perf_counter()
                self.setup_s = win.t0 - self.t_start
                yield win
                self.sync()
                win.t1 = time.perf_counter()
        self.window_s = win.seconds
        self.peak_bytes = self.read_peak()
        if self.traced:
            self.trace = tr.reduce(prof, {}, None)
