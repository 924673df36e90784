"""peak_device_mb: torch.cuda.max_memory_allocated from the start of the
program's set-up to the close of the window, in 10^6 bytes."""


def read(run):
    return run.peak_bytes / 1e6
