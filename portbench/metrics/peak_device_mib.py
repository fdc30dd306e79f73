"""Card memory a deployment pays for: torch.cuda.max_memory_allocated()
over set-up and window (reset at process start), in MiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**20
