from repro_torch.data.pipeline import (DataConfig, make_batch,
                                       synthetic_stream, zipf_bigram_tokens)

__all__ = ["DataConfig", "make_batch", "synthetic_stream",
           "zipf_bigram_tokens"]
