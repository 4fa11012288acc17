from openkeonspark_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager, export_parameters, import_parameters,
    latest_step, load_params, params_from_numpy, read_parameters,
    save_params, warm_start_from, warm_start_path)
