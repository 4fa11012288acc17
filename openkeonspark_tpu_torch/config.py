"""Run configuration: the reference's numpy-only ``Config``, reused by
import. Never call ``Config.eval_chunk_size`` from the port: it imports
jax; use :func:`openkeonspark_tpu_torch.runtime.eval_chunk_size`."""

from openkeonspark_tpu.config import Config  # noqa: F401
