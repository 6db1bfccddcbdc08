from repro_torch.serve.step import (greedy_sample, make_decode_step,
                                    make_prefill_step, serve_batch)

__all__ = ["greedy_sample", "make_decode_step", "make_prefill_step",
           "serve_batch"]
