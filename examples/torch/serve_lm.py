"""Serve a small model with batched requests on the port: prefill +
greedy decode (the counterpart of ``examples/serve_lm.py``; the reduced
llama3.2-1b's head dim 32 runs the CUDA-core flash-attention kernel on
the card).

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
        [--prompt-len N] [--params NPZ]

``--params`` serves given bf16 weights (``param.<path>`` bit patterns,
e.g. the reference's, as ``tests/torch_examples_serve.npz`` holds them)
instead of seed-made ones.
"""
import argparse

from repro_torch.launch import serve as serve_launcher


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--params", default=None, metavar="NPZ")
    ap.add_argument("--out", default="results/torch",
                    help="artifact directory (this example writes none)")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    extra += [] if args.params is None else ["--params", args.params]
    return serve_launcher.run(["--arch", "llama3.2-1b", "--reduced",
                               "--batch", "4",
                               "--prompt-len", str(args.prompt_len),
                               "--max-new", "16"] + extra)


if __name__ == "__main__":
    main()
