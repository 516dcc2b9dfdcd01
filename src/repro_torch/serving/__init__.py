"""LM serving on the port: prefill, decode (``serve_step``) and the
request scheduler (port of ``repro/serving``)."""
from repro_torch.serving.decode import sample_token, serve_step
from repro_torch.serving.prefill import prefill
from repro_torch.serving.scheduler import BatchScheduler, Request

__all__ = ["prefill", "serve_step", "sample_token", "BatchScheduler",
           "Request"]
