from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    flatten_with_paths,
    gc_old_steps,
    latest_step,
    list_steps,
    restore,
    save,
)
