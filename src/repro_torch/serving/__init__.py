from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.kv_cache import PagePool, PagedSpec
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
