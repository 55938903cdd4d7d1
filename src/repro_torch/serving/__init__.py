"""Serving tier: continuous batching for the distilled student
(``repro.serving``).

- ``Engine`` (engine.py): padded-bucket prefill/decode split over one
  persistent slot cache; ``RequestState``/``StreamResult`` request API.
- ``Scheduler`` (scheduler.py): pure-python buckets / slots / admission.
- ``serve_batch`` (batch.py): fixed-batch serial reference, and
  ``compare_stream``, the parity rule between the two.
"""
from repro_torch.serving.batch import (compare_stream, effective_tokens,
                                       serve_batch)
from repro_torch.serving.engine import Engine, StreamResult
from repro_torch.serving.scheduler import (Admission, RequestState, Scheduler,
                                           SlotAllocator, round_pow2)

__all__ = ["Engine", "StreamResult", "Scheduler", "SlotAllocator",
           "Admission", "RequestState", "serve_batch", "compare_stream",
           "effective_tokens", "round_pow2"]
