from openkeonspark_tpu_torch.sampling.device import (  # noqa: F401
    DeviceSampler, SampledBatch)
