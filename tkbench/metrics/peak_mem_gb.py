"""peak_mem_gb: torch.cuda.max_memory_allocated over the window (reset as it
opens), in 1e9 bytes: the resident operator, the right-hand-side pool and
whatever a solve allocates."""


def read(t):
    return t.peak_bytes / 1e9 if t.peak_bytes else None
