"""Device allocations a request: the caching allocator's
``num_device_alloc`` and ``num_alloc_retries`` deltas over the program's
outermost spans in the traced window (the prefill's layers, its cache
fill, last logits and sample), over the window's requests.  Moves
``prefill_tok_s``."""
import program_spans


def read(t):
    if t.info.get("kind") != "prefill" or not t.info["requests"]:
        return None
    top = [r for r in program_spans.records(t) if r["parent"] is None]
    if not top:
        return None
    return sum(r["num_device_alloc"] + r["num_alloc_retries"]
               for r in top) / t.info["requests"]
