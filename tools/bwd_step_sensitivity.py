"""How far a wrong attention backward moves a training step, on the CPU.

``chip_smoke.py`` phase 21 (c) holds each reduced config's card step with
the flash backward kernel against the same step with
``attention_backward_plain`` in the kernel's place, at
``torch_parity.BWD_STEP_TOL``.  This script shows what that bound can
tell apart: for each reduced config of ``tests/torch_lm_train.npz`` it
runs the port's step on the CPU with the plain backward, then again with
the plain backward's output changed by a test double (dQ halved, dK 10%
low, dV 5% low, or every element moved by up to half a bf16 ulp, as two
bf16 roundings apart would), and prints ``torch_parity.step_vs_plain_backward``
for each with whether it stays within the bound.  Needs no card and no
JAX:

    PYTHONPATH=src python tools/bwd_step_sensitivity.py
"""
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "src"))

import torch_parity as tp                                   # noqa: E402
from repro_torch.kernels import flash_attention as FA       # noqa: E402


def _rounding_noise(x):
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(x.shape, generator=gen) - 0.5
    return (x.float() * (1 + u * 2.0 ** -7)).to(x.dtype)


#: name -> (dq, dk, dv) -> (dq, dk, dv)
CHANGES = {
    "dq x 0.5": lambda dq, dk, dv: (dq * 0.5, dk, dv),
    "dk x 0.9": lambda dq, dk, dv: (dq, dk * 0.9, dv),
    "dv x 0.95": lambda dq, dk, dv: (dq, dk, dv * 0.95),
    "half-ulp noise": lambda *g: tuple(map(_rounding_noise, g)),
}


def main() -> int:
    torch.manual_seed(0)
    z = np.load(tp.LM_TRAIN_FIXTURE)
    plain = FA.attention_backward_plain
    print(f"bound {tp.BWD_STEP_TOL}")
    for arch in tp.LM_TRAIN_ARCHS:
        base = tp.lm_train_step(z, arch, "cpu")
        cells = []
        for name, change in CHANGES.items():
            FA.attention_backward_plain = (
                lambda *a, change=change, **kw: change(*plain(*a, **kw)))
            try:
                got = tp.lm_train_step(z, arch, "cpu")
            finally:
                FA.attention_backward_plain = plain
            e = tp.step_vs_plain_backward(got, base)
            within = all(e[k] <= tp.BWD_STEP_TOL[k] for k in tp.BWD_STEP_TOL)
            cells.append(f"{name}: leaf {e['grad']:.3e} grad_norm "
                         f"{e['grad_norm']:.2e} "
                         f"{'within' if within else 'BEYOND'}")
        print(f"{arch}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
